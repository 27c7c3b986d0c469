"""Perf exploration harness (not the headline bench): times solver variants
on the current backend to locate the bottleneck before optimizing.

Usage: python tools/bench_explore.py [variant ...]
Variants: default, no_obstacle, few_alphas, few_iters, small_batch, horizon10
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def timed_solve(prob, B, reps=3, label=""):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, 3))),
    )
    U0 = jnp.zeros((B,) + prob.default_u0.shape)
    solve = jax.jit(jax.vmap(prob.solve))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(thetas, U0))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(thetas, U0))
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(
        f"{label:14s} B={B:5d} compile={compile_s:6.1f}s best={best*1e3:8.2f}ms "
        f"-> {B/best:10.1f} solves/s"
    )
    return best


def main():
    import jax.numpy as jnp

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.models import unicycle
    from ros2_mpc_jax.ops import costs
    from ros2_mpc_jax.ops.integrators import make_step
    from ros2_mpc_jax.solver.ilqr import SolverSettings, make_solver
    from ros2_mpc_jax.solver.problems import Problem, make_point_stabilization

    params = Params()
    N = 20
    which = sys.argv[1:] or ["default", "no_obstacle", "few_alphas", "few_iters", "small_batch"]

    if "default" in which:
        timed_solve(make_point_stabilization(params, horizon=N), 4096, label="default")

    if "no_obstacle" in which:
        # structurally remove the 160-point obstacle sum from the stage cost
        F = make_step(unicycle.f, "rk4", params.dt)

        def stage_cost(x, u, k, theta):
            e = x - theta["goal"]
            return (
                costs.quadratic_error(e, theta["Q"])
                + costs.quadratic_error(u, theta["R"])
                + costs.reverse_penalty(u, theta["reverse_factor"])
            )

        base = make_point_stabilization(params, horizon=N)
        ocp = base.ocp._replace(stage_cost=stage_cost)
        prob = Problem(
            solve=make_solver(ocp, base.settings),
            make_theta=base.make_theta,
            default_u0=base.default_u0,
            ocp=ocp,
            settings=base.settings,
        )
        timed_solve(prob, 4096, label="no_obstacle")

    if "few_alphas" in which:
        s = SolverSettings(n_alphas=5)
        timed_solve(make_point_stabilization(params, horizon=N, settings=s), 4096, label="few_alphas")

    if "few_iters" in which:
        s = SolverSettings(barrier_stages=8, iters_per_stage=4)
        timed_solve(make_point_stabilization(params, horizon=N, settings=s), 4096, label="few_iters(32)")

    if "small_batch" in which:
        timed_solve(make_point_stabilization(params, horizon=N), 512, label="small_batch")

    if "horizon10" in which:
        timed_solve(make_point_stabilization(params, horizon=10), 4096, label="horizon10")


if __name__ == "__main__":
    main()
