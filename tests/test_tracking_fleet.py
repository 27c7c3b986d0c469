"""Tracking-fleet closed loop (parallel/fleet.py::make_tracking_fleet_rollout):
the fleet-scale evaluator for the reference's flagship path-following loop
(ros2_mpc/scripts/path_follower_local_planner.py:134-223), rebuilt as one
jitted lax.scan per device — per-robot reference windows advancing along
per-robot paths, tracking-bank solve, RK4 plant, shifted warm starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.parallel.fleet import (
    _tracking_window,
    arc_path_fleet,
    make_sharded_tracking_fleet_rollout,
    make_tracking_fleet_rollout,
)
from ros2_mpc_jax.parallel.mesh import make_mesh, shard_bank
from ros2_mpc_jax.solver import SolverSettings, make_tracking

PARAMS = Params()
FAST = SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
N = 8


def _problem(**kw):
    return make_tracking(PARAMS, horizon=N, settings=FAST, reference_parity=False, **kw)


def test_tracking_window_matches_host_reference_gen():
    """The in-jit window generator must agree with the host-side
    quirk-faithful helper (nodes/reference_gen.py::tracking_reference_window)
    on anchor choice, clamping, and the 0.5 m terminal latch."""
    from ros2_mpc_jax.nodes.reference_gen import tracking_reference_window

    rng = np.random.default_rng(0)
    P = 20
    t = np.linspace(0, 2.0, P)
    wps = np.stack([t, 0.3 * np.sin(t)], axis=1)
    yaw = np.arctan2(np.gradient(wps[:, 1]), np.gradient(wps[:, 0]))
    speed = np.full(P, 0.15)
    omega = np.gradient(yaw) / 2
    goal = np.array([wps[-1, 0], wps[-1, 1], yaw[-1]])
    for pos in [np.array([0.3, 0.1]), np.array([1.4, -0.2]), wps[-1] + 0.05]:
        state = np.array([pos[0], pos[1], 0.0])
        near_end = np.linalg.norm(pos - wps[-1]) < 0.5
        x_host, u_host = tracking_reference_window(
            state, goal, wps, yaw, speed, omega, horizon=N
        )
        x_dev, u_dev, ct = _tracking_window(
            jnp.asarray(pos),
            jnp.asarray(goal),
            jnp.asarray(wps),
            jnp.asarray(yaw),
            jnp.asarray(speed),
            jnp.asarray(omega),
            N,
        )
        np.testing.assert_allclose(
            np.asarray(x_dev).ravel(), np.asarray(x_host).ravel(), atol=1e-6
        )
        if near_end:
            # documented corrected-mode deviation: park (zero u_ref) inside
            # the terminal latch instead of the host window's profile speed
            np.testing.assert_allclose(np.asarray(u_dev), 0.0, atol=1e-6)
        else:
            np.testing.assert_allclose(
                np.asarray(u_dev).ravel(), np.asarray(u_host).ravel(), atol=1e-6
            )
        d = np.linalg.norm(wps - pos, axis=1).min()
        np.testing.assert_allclose(float(ct), d, atol=1e-6)


def test_tracking_fleet_follows_paths():
    """A small fleet on arc paths must reach the path ends with small
    cross-track error — the closed-loop quality gate for the flagship loop.
    Uses the corrected parking mode (terminal weight): under the parity
    formulation the reverse penalty exp(-rf*v) rewards full throttle at any
    goal distance, so a robot that misses the 0.15 m latch flies straight
    through (the ROADMAP goal-orbiting family; see the comparison test)."""
    prob = _problem(terminal_weight=(10.0, 10.0, 1.0))
    thetas, paths, U0 = arc_path_fleet(prob, B=8, n_waypoints=48, seed=2)
    # enough ticks to traverse: path length ~ 47 * v_nom * dt, robot does
    # ~2*v_nom real -> ~24 ticks; give margin for acquisition
    roll = make_tracking_fleet_rollout(prob, n_ticks=48, dt=PARAMS.dt, goal_threshold=0.25)
    out = roll(thetas, paths, U0)
    assert float(out.reach_fraction) >= 0.9
    assert float(out.mean_cross_track) < 0.12
    assert np.all(np.isfinite(np.asarray(out.final_states)))


def test_tracking_fleet_pallas_matches_vmap():
    """The Pallas tracking kernel inside the closed loop (interpret mode on
    CPU) must reproduce the vmap engine's trajectories."""
    prob = _problem()
    B = 16  # tile_s=2 * tile_l=8
    thetas, paths, U0 = arc_path_fleet(prob, B=B, n_waypoints=32, seed=3)
    n_ticks = 6
    ref = make_tracking_fleet_rollout(prob, n_ticks, PARAMS.dt, record=True)(
        thetas, paths, U0
    )
    got = make_tracking_fleet_rollout(
        prob, n_ticks, PARAMS.dt, record=True, engine="pallas",
        interpret=True, tile_s=2, tile_l=8,
    )(thetas, paths, U0)
    np.testing.assert_allclose(
        np.asarray(got.trajectories), np.asarray(ref.trajectories), atol=2e-3
    )
    np.testing.assert_allclose(
        float(got.mean_cross_track), float(ref.mean_cross_track), atol=2e-3
    )


def test_tracking_fleet_corrected_beats_parity():
    """The corrected parking stack (yaw-error wrap + terminal weight +
    in-scan point-stab handoff) must dominate the parity formulation at
    fleet scale: under parity the raw yaw subtraction forces long-way-around
    turns and the reverse penalty drives fly-bys past the goal (measured:
    5/8 reach on this bank); corrected parks all of them. This is the
    quantitative case for the corrected mode (round-4 verdict item 3)."""
    prob_c = _problem(terminal_weight=(10.0, 10.0, 1.0))
    prob_p = make_tracking(PARAMS, horizon=N, settings=FAST, reference_parity=True)
    thetas_c, paths, U0 = arc_path_fleet(prob_c, B=8, n_waypoints=48, seed=2)
    thetas_p, _, _ = arc_path_fleet(prob_p, B=8, n_waypoints=48, seed=2)
    n_ticks = 48
    out_c = make_tracking_fleet_rollout(
        prob_c, n_ticks, PARAMS.dt, goal_threshold=0.25
    )(thetas_c, paths, U0)
    # parity formulation: no handoff (it would override the reference's own
    # weights) — the pre-correction behavior under test
    out_p = make_tracking_fleet_rollout(
        prob_p, n_ticks, PARAMS.dt, goal_threshold=0.25, handoff_radius=None
    )(thetas_p, paths, U0)
    assert float(out_c.reach_fraction) >= float(out_p.reach_fraction) + 0.2
    assert float(out_c.reach_fraction) == 1.0
    assert float(out_c.mean_cross_track) < 0.1


def test_sharded_tracking_fleet_matches_unsharded():
    """Sharding over the 8-device mesh is exact (robots independent)."""
    prob = _problem()
    B = 32
    thetas, paths, U0 = arc_path_fleet(prob, B=B, n_waypoints=32, seed=5)
    n_ticks = 6
    plain = make_tracking_fleet_rollout(prob, n_ticks, PARAMS.dt)(thetas, paths, U0)
    mesh = make_mesh(8)
    sharded = make_sharded_tracking_fleet_rollout(prob, mesh, n_ticks, PARAMS.dt)(
        shard_bank(thetas, mesh), shard_bank(paths, mesh), shard_bank(U0, mesh)
    )
    np.testing.assert_allclose(
        np.asarray(sharded.final_states), np.asarray(plain.final_states), atol=1e-5
    )
    np.testing.assert_allclose(
        float(sharded.mean_cross_track), float(plain.mean_cross_track), atol=1e-5
    )


def test_sharded_tracking_fleet_records_ticks_like_unsharded():
    """record=True returns the (T+1, B, 3) states and the (T, B) per-tick
    convergence flags, sharded or not."""
    prob = _problem()
    B, n_ticks = 16, 3
    thetas, paths, U0 = arc_path_fleet(prob, B=B, n_waypoints=32, seed=6)
    plain = make_tracking_fleet_rollout(prob, n_ticks, PARAMS.dt, record=True)(
        thetas, paths, U0
    )
    mesh = make_mesh(8)
    sharded = make_sharded_tracking_fleet_rollout(prob, mesh, n_ticks, PARAMS.dt, record=True)(
        shard_bank(thetas, mesh), shard_bank(paths, mesh), shard_bank(U0, mesh)
    )
    assert plain.trajectories.shape == (n_ticks + 1, B, 3)
    assert plain.converged.shape == (n_ticks, B) and plain.converged.dtype == jnp.bool_
    np.testing.assert_allclose(
        np.asarray(sharded.trajectories), np.asarray(plain.trajectories), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(sharded.converged), np.asarray(plain.converged))


def test_tracking_fleet_rejects_point_stab_problem():
    from ros2_mpc_jax.solver import make_point_stabilization

    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    with pytest.raises(ValueError, match="tracking"):
        make_tracking_fleet_rollout(prob, n_ticks=4, dt=PARAMS.dt)
