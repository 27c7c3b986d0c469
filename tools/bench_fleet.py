"""Fleet closed-loop throughput on the default device: robots x ticks per second."""

import os
import sys
import time

# runnable as `python tools/bench_fleet.py` without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(engine="pallas", B=4096, T=100, N=20):
    import jax

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel.fleet import make_fleet_rollout, random_fleet
    from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization

    P = Params()
    prob = make_point_stabilization(P, horizon=N, settings=SolverSettings.realtime())
    thetas, U0 = random_fleet(prob, B=B, seed=0, spread=1.2)
    rollout = make_fleet_rollout(prob, n_ticks=T, dt=P.dt, engine=engine)
    t0 = time.perf_counter()
    out = rollout(thetas, U0)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rollout(thetas, U0)
    jax.block_until_ready(out)
    run_s = time.perf_counter() - t0
    print(
        f"engine={engine} B={B} T={T} N={N} compile={compile_s:.1f}s run={run_s*1e3:.1f}ms "
        f"-> {B*T/run_s:,.0f} robot-ticks/s (sim-to-real ratio {B*T*P.dt/run_s:,.0f}x) "
        f"reach={float(out.reach_fraction)*100:.1f}% mean_dist={float(out.mean_dist):.3f}",
        flush=True,
    )


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["pallas"]))
