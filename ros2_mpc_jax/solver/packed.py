"""Packed-theta solve paths: one host->device transfer per control tick.

The ``Problem.make_theta`` dicts are ideal for sweeps (every weight is a
vmappable runtime leaf) but cost one host->device transfer *per leaf* on
every live tick, and each transfer pays dispatch latency. For the
single-robot tick path the weights are fixed at node construction; only the
sensor-derived fields change. These builders bake the
constant leaves into the compiled program and accept the dynamic fields as a
single flat float32 vector, so a live tick ships exactly two arrays (packed
sensors + warm start) down and one control back.

Layout (point stabilization, n = n_obstacle_points):
    [x0(3) | goal(3) | obs_x(n) | obs_y(n)]
Layout (tracking, horizon N):
    [x0(3) | x_ref(N*3) | u_ref(N*2) | obs_x(n) | obs_y(n)]
"""

from __future__ import annotations

import numpy as np


from ..config import Params
from .problems import Problem
from .warmstart import shift_controls


def make_packed_point_stab(problem: Problem, params: Params = Params(), solve_fn=None):
    """(solve_packed, pack) for a point-stabilization problem.

    ``solve_packed(vec, U0) -> (Solution, U_warm_next)`` is jit-compatible;
    the shift-and-hold warm start for the next tick is produced inside the
    same compiled program, so a live tick is exactly one dispatch. ``pack``
    is the host-side encoder (pure NumPy, no device work).

    ``solve_fn`` swaps the engine: any ``f(theta, U0, *extra) -> Solution``
    on the same OCP (e.g. ``mppi.make_hybrid_solver`` output, which takes a
    PRNG key as ``extra``) — the packed wrapper forwards ``*extra``."""
    n = params.n_obstacle_points
    const = problem.make_theta(np.zeros(3), np.zeros(3))
    solve = solve_fn if solve_fn is not None else problem.solve

    def solve_packed(vec, U0, *extra):
        theta = dict(const)
        theta["x0"] = vec[0:3]
        theta["goal"] = vec[3:6]
        theta["obs_x"] = vec[6 : 6 + n]
        theta["obs_y"] = vec[6 + n : 6 + 2 * n]
        sol = solve(theta, U0, *extra)
        return sol, shift_controls(sol.U)

    def pack(x0, goal, obs_x, obs_y) -> np.ndarray:
        return np.concatenate(
            [
                np.asarray(x0, dtype=np.float32).reshape(3),
                np.asarray(goal, dtype=np.float32).reshape(3),
                np.asarray(obs_x, dtype=np.float32).reshape(n),
                np.asarray(obs_y, dtype=np.float32).reshape(n),
            ]
        )

    return solve_packed, pack


def make_packed_tracking(problem: Problem, params: Params = Params(), solve_fn=None):
    """(solve_packed, pack) for a tracking problem; same contract as
    :func:`make_packed_point_stab` (Solution + in-jit shifted warm start,
    optional engine swap via ``solve_fn`` with ``*extra`` forwarding)."""
    n = params.n_obstacle_points
    N = problem.ocp.horizon
    const = problem.make_theta(np.zeros(3), np.zeros((N, 3)), np.zeros((N, 2)))
    solve = solve_fn if solve_fn is not None else problem.solve

    def solve_packed(vec, U0, *extra):
        theta = dict(const)
        theta["x0"] = vec[0:3]
        theta["x_ref"] = vec[3 : 3 + 3 * N].reshape(N, 3)
        theta["u_ref"] = vec[3 + 3 * N : 3 + 5 * N].reshape(N, 2)
        theta["obs_x"] = vec[3 + 5 * N : 3 + 5 * N + n]
        theta["obs_y"] = vec[3 + 5 * N + n : 3 + 5 * N + 2 * n]
        sol = solve(theta, U0, *extra)
        return sol, shift_controls(sol.U)

    def pack(x0, x_ref, u_ref, obs_x, obs_y) -> np.ndarray:
        return np.concatenate(
            [
                np.asarray(x0, dtype=np.float32).reshape(3),
                np.asarray(x_ref, dtype=np.float32).reshape(3 * N),
                np.asarray(u_ref, dtype=np.float32).reshape(2 * N),
                np.asarray(obs_x, dtype=np.float32).reshape(n),
                np.asarray(obs_y, dtype=np.float32).reshape(n),
            ]
        )

    return solve_packed, pack


def device_tick_rate(problem, n_ticks: int = 64, dt: float = 0.2):
    """Seconds per warm control tick with the whole loop device-resident —
    the fleet ``lax.scan`` pattern (solve -> actuate -> shift with no
    per-tick dispatch) on one block of the whole-solver kernel (a single
    robot pays the same block latency). This is the latency floor the
    dispatched single-tick number should be compared against."""
    import time

    import jax

    from ..parallel.fleet import make_fleet_rollout, random_fleet
    from .pallas_kernel import TILE_L, TILE_S

    rollout = make_fleet_rollout(problem, n_ticks=n_ticks, dt=dt, engine="pallas")
    thetas, U0 = random_fleet(problem, B=TILE_S * TILE_L, seed=0)
    jax.block_until_ready(rollout(thetas, U0))  # compile
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(rollout(thetas, U0))
        reps.append((time.perf_counter() - t0) / n_ticks)
    return float(np.min(reps))
