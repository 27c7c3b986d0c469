"""Worker for the multi-process (multi-host analogue) scaling measurement.

Launched (never imported) by ros2_mpc_jax.parallel.scaling_bench's
distributed mode and by tests/test_scaling_distributed.py: 2 OS processes x
4 virtual CPU devices form one 8-device global mesh over local TCP. Each
engine is timed twice:

* **1-dev baseline**: a process-local single-device bank solve (no mesh, no
  collectives) on ``jax.local_devices()[0]`` — run on process 0 while the
  other process parks in a coordination barrier;
* **8-dev global**: the sharded bank step over the full global mesh — the
  telemetry all-reduces cross the process (TCP) boundary every step, which
  is exactly the cross-host path a real cluster pays.

Process 0 prints one ``DIST_SCALING_OK {json}`` line with per-engine
throughput and efficiency. The same contention caveat as the virtual-mesh
bench applies (8 virtual devices on 2 physical cores: ceiling = cores /
devices); ``efficiency_vs_ceiling`` is the partitioning+collective number
this environment can actually validate.
"""

import json
import os
import sys
import time


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel.distributed import initialize
    from ros2_mpc_jax.parallel.mesh import make_bank_solver, make_mesh
    from ros2_mpc_jax.solver import make_point_stabilization
    from ros2_mpc_jax.solver.mppi import MppiSettings

    info = initialize()
    assert info["initialized"] and info["process_count"] == 2, info
    from jax.experimental import multihost_utils

    from ros2_mpc_jax.solver import SolverSettings

    N = 10
    per_dev = 64
    reps = 3
    prob = make_point_stabilization(Params(), horizon=N)
    # composites run a short schedule (the measurement is collective/TCP
    # overhead, and interpret-mode Pallas passes dominate otherwise)
    short = SolverSettings(barrier_stages=3, iters_per_stage=2, n_alphas=4)
    prob_short = make_point_stabilization(Params(), horizon=N, settings=short)
    n_global = info["global_devices"]
    proc = info["process_index"]

    def bank(B, p=None):
        rng = np.random.default_rng(0)
        thetas = jax.vmap((p or prob).make_theta)(
            jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3))),
            jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3))),
        )
        return jax.tree.map(np.asarray, thetas), np.zeros((B, N, 2), np.float32)

    engines = {
        "vmap": (prob, {}),
        "fast": (prob, {"lanes": per_dev}),
        "pallas": (prob, {"tile_s": 1, "tile_l": per_dev, "interpret": True}),
        "mppi": (prob, {"settings": MppiSettings(n_samples=16, n_iters=2)}),
        # production composites across the process boundary (round-5 item 8)
        "two_pass": (
            prob_short,
            {
                "capacity": per_dev // 2,
                "tile_s": 1,
                "tile_l": per_dev,
                "rescue_settings": short,
                "interpret": True,
            },
        ),
        "multistart_bank": (
            prob_short,
            {"swing_fracs": (1.0,), "inner_engine": "fast", "lanes": per_dev},
        ),
        "multistart_rescue": (
            prob_short,
            {
                "swing_fracs": (1.0,),
                "inner_engine": "fast",
                "lanes": per_dev,
                "capacity": per_dev // 2,
                "rescue_settings": short,
                "polish_iters": 2,
            },
        ),
    }

    results = []
    for engine, (prob_e, opts) in engines.items():
        # --- 1-dev process-local baseline (proc 0 measures; proc 1 waits)
        multihost_utils.sync_global_devices(f"pre-base-{engine}")
        base_rate = 0.0
        if proc == 0:
            th_h, U0_h = bank(per_dev, prob_e)
            mesh1 = make_mesh(1)  # first global device == proc 0's first local
            step1 = make_bank_solver(prob_e, mesh1, engine=engine, **opts)
            th1 = jax.device_put(jax.tree.map(jnp.asarray, th_h))
            U01 = jax.device_put(jnp.asarray(U0_h))
            jax.block_until_ready(step1(th1, U01))
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(step1(th1, U01))
                ts.append(time.perf_counter() - t0)
            base_rate = per_dev / min(ts)
        multihost_utils.sync_global_devices(f"post-base-{engine}")

        # --- n-dev global-mesh step (both processes participate)
        B = per_dev * n_global
        th_h, U0_h = bank(B, prob_e)
        mesh = make_mesh()
        sharding = NamedSharding(mesh, P("scenario"))

        def to_global(a):
            a = np.asarray(a)
            return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])

        thetas = jax.tree.map(to_global, th_h)
        U0 = to_global(U0_h)
        step = make_bank_solver(prob_e, mesh, engine=engine, **opts)
        jax.block_until_ready(step(thetas, U0))
        multihost_utils.sync_global_devices(f"pre-global-{engine}")
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(step(thetas, U0))
            ts.append(time.perf_counter() - t0)
        global_rate = B / min(ts)
        multihost_utils.sync_global_devices(f"post-global-{engine}")

        if proc == 0:
            eff = global_rate / (base_rate * n_global)
            results.append(
                {
                    "engine": engine,
                    "solves_per_s_1dev": base_rate,
                    "solves_per_s_ndev": global_rate,
                    "scaling_efficiency": eff,
                }
            )

    # --- Per-tick all_gather swarm across the process boundary: the one
    # workload whose collectives are IN the control loop (positions +
    # velocities gathered every tick), so the TCP path is paid n_ticks times
    # per dispatch — the honest multi-host analogue for the coupled fleet.
    from ros2_mpc_jax.parallel.fleet import (
        circle_swarm,
        make_sharded_swarm_rollout,
        make_swarm_rollout,
    )

    prob_sw = make_point_stabilization(
        Params(), horizon=N, settings=short, reference_parity=False
    )
    n_ticks = 8
    multihost_utils.sync_global_devices("pre-base-swarm")
    base_rate = 0.0
    if proc == 0:
        th_h, U0_h = circle_swarm(prob_sw, per_dev, jitter=0.06)
        roll1 = make_swarm_rollout(
            prob_sw, n_ticks=n_ticks, dt=Params().dt, k_neighbors=2
        )
        jax.block_until_ready(roll1(th_h, U0_h).final_states)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(roll1(th_h, U0_h).final_states)
            ts.append(time.perf_counter() - t0)
        base_rate = per_dev * n_ticks / min(ts)
    multihost_utils.sync_global_devices("post-base-swarm")

    B_sw = per_dev * n_global
    th_h, U0_h = circle_swarm(prob_sw, B_sw, jitter=0.06)
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("scenario"))

    def to_global_sw(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])

    th_g = jax.tree.map(to_global_sw, jax.tree.map(np.asarray, th_h))
    U0_g = to_global_sw(np.asarray(U0_h))
    roll = make_sharded_swarm_rollout(
        prob_sw, mesh, n_ticks=n_ticks, dt=Params().dt, k_neighbors=2
    )
    jax.block_until_ready(roll(th_g, U0_g).final_states)
    multihost_utils.sync_global_devices("pre-global-swarm")
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(roll(th_g, U0_g).final_states)
        ts.append(time.perf_counter() - t0)
    global_rate = B_sw * n_ticks / min(ts)
    multihost_utils.sync_global_devices("post-global-swarm")
    if proc == 0:
        results.append(
            {
                "engine": "swarm_allgather",
                "solves_per_s_1dev": base_rate,  # robot-ticks/s
                "solves_per_s_ndev": global_rate,
                "scaling_efficiency": global_rate / (base_rate * n_global),
            }
        )

    if proc == 0:
        ceiling = min(1.0, (os.cpu_count() or 1) / n_global)
        for r in results:
            r["efficiency_vs_ceiling"] = min(1.0, r["scaling_efficiency"] / ceiling)
        out = {
            "mode": "2-process jax.distributed over TCP (multi-host analogue)",
            "processes": info["process_count"],
            "global_devices": n_global,
            "per_device_batch": per_dev,
            "horizon": N,
            "physical_cores": os.cpu_count(),
            "contention_ceiling": ceiling,
            "results": results,
        }
        print("DIST_SCALING_OK " + json.dumps(out))
        sys.stdout.flush()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
