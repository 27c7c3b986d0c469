"""Worker program for the true multi-process jax.distributed test.

Launched (never imported) by tests/test_distributed.py: two OS processes x
4 virtual CPU devices each, wired into one 8-device global mesh over local
TCP. Runs one sharded bank step and cross-checks it against a process-local
full-bank solve, then prints DIST_OK with the metrics.
"""

import json
import os
import sys

# Env must be set by the launcher: JAX_PLATFORMS=cpu,
# XLA_FLAGS=--xla_force_host_platform_device_count=4, JAX_COORDINATOR_ADDRESS,
# JAX_NUM_PROCESSES, JAX_PROCESS_ID.


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel.distributed import initialize
    from ros2_mpc_jax.parallel.mesh import make_bank_solver, make_mesh
    from ros2_mpc_jax.solver import make_point_stabilization

    info = initialize()
    assert info["initialized"], info
    assert info["process_count"] == 2, info
    assert info["local_devices"] == 4, info
    assert info["global_devices"] == 8, info

    N, B = 10, 16
    prob = make_point_stabilization(Params(), horizon=N)
    rng = np.random.default_rng(0)  # identical bank on every process
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = rng.uniform(-1.0, 1.0, size=(B, 3))
    thetas_host = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    thetas_host = jax.tree.map(np.asarray, thetas_host)
    U0_host = np.zeros((B, N, 2), dtype=np.float32)

    mesh = make_mesh()  # all 8 global devices
    sharding = NamedSharding(mesh, P("scenario"))

    def to_global(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])

    thetas = jax.tree.map(to_global, thetas_host)
    U0 = to_global(U0_host)

    step = make_bank_solver(prob, mesh, engine="vmap")
    sols, metrics = step(thetas, U0)
    jax.block_until_ready(sols)

    # Cross-check: gather the sharded controls and compare to a purely
    # process-local full-bank solve (no mesh, local devices only).
    from jax.experimental import multihost_utils

    U_global = multihost_utils.process_allgather(sols.U, tiled=True)
    ref = jax.jit(jax.vmap(prob.solve))(
        jax.tree.map(jnp.asarray, thetas_host), jnp.asarray(U0_host)
    )
    err = float(np.max(np.abs(np.asarray(U_global) - np.asarray(ref.U))))
    assert err <= 1e-5, f"sharded-vs-local drift {err:.2e}"

    # Coupled-fleet path: the sharded swarm all_gathers fleet positions and
    # velocities over the global mesh EVERY control tick, so the collective
    # crosses the process (multi-host-analogue TCP) boundary. Cross-check against a
    # process-local unsharded swarm.
    from ros2_mpc_jax.parallel.fleet import make_swarm_rollout, make_sharded_swarm_rollout
    from ros2_mpc_jax.solver import SolverSettings

    tiny = SolverSettings(barrier_stages=2, iters_per_stage=2, n_alphas=4)
    prob_c = make_point_stabilization(
        Params(), horizon=6, settings=tiny, reference_parity=False
    )
    thetas_c_host = jax.tree.map(
        np.asarray, jax.vmap(prob_c.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    )
    U0c_host = np.zeros((B, 6, 2), dtype=np.float32)
    swarm = make_sharded_swarm_rollout(
        prob_c, mesh, n_ticks=3, dt=Params().dt, k_neighbors=2
    )
    res_sw = swarm(jax.tree.map(to_global, thetas_c_host), to_global(U0c_host))
    jax.block_until_ready(res_sw.final_states)
    xs_global = multihost_utils.process_allgather(res_sw.final_states, tiled=True)
    res_ref = make_swarm_rollout(prob_c, 3, Params().dt, k_neighbors=2)(
        jax.tree.map(jnp.asarray, thetas_c_host), jnp.asarray(U0c_host)
    )
    swarm_err = float(np.max(np.abs(np.asarray(xs_global) - np.asarray(res_ref.final_states))))
    assert swarm_err <= 1e-5, f"sharded-swarm drift {swarm_err:.2e}"

    out = {
        "process_index": info["process_index"],
        "process_count": info["process_count"],
        "global_devices": info["global_devices"],
        "mean_cost": float(metrics["mean_cost"]),
        "frac_converged": float(metrics["frac_converged"]),
        "max_err_vs_local": err,
        "swarm_err_vs_local": swarm_err,
        "swarm_min_separation": float(res_sw.min_separation),
    }
    print("DIST_OK " + json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
