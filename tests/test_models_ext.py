"""Beyond-reference model families (solver/problems_ext.py): the solver core
is generic over the OCP template, so a kinematic bicycle, a
smooth-actuation unicycle, and a 12-state quadrotor drop in without
touching the engines. Dynamics are
pinned against analytic closed forms; solves against KKT optimality and
goal-reaching rollouts. The lane-aligned bank engine is model-generic
(bank-parity tests live in test_batched_generic.py); only the Pallas
kernels are unicycle-specialized and must reject these kinds loudly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.models import bicycle, unicycle_dyn
from ros2_mpc_jax.ops.integrators import make_step, rollout
from ros2_mpc_jax.solver import (
    make_bicycle_point_stabilization,
    make_smooth_point_stabilization,
)

PARAMS = Params()


def test_bicycle_constant_steer_is_circular_arc():
    """Constant (v, delta) must trace a circle of radius L / tan(delta)."""
    L, v, delta, dt = 0.3, 0.2, 0.3, 0.01
    F = make_step(bicycle.make_f(L), "rk4", dt)
    T = 500
    X = rollout(F, jnp.zeros(3), jnp.tile(jnp.array([v, delta]), (T, 1)))
    R = L / np.tan(delta)
    # the arc's center is at (0, R); every state must stay on the circle
    d = np.hypot(np.asarray(X[:, 0]), np.asarray(X[:, 1]) - R)
    np.testing.assert_allclose(d, R, rtol=1e-5)
    # heading advances at v/R rad/s
    np.testing.assert_allclose(float(X[-1, 2]), v / R * T * dt, rtol=1e-5)


def test_smooth_unicycle_constant_accel_closed_form():
    """From rest on a straight line: v = a t, x = a t^2 / 2."""
    a, dt, T = 0.25, 0.01, 400
    F = make_step(unicycle_dyn.f, "rk4", dt)
    X = rollout(F, jnp.zeros(5), jnp.tile(jnp.array([a, 0.0]), (T, 1)))
    t = T * dt
    np.testing.assert_allclose(float(X[-1, 3]), a * t, rtol=1e-6)
    np.testing.assert_allclose(float(X[-1, 0]), 0.5 * a * t * t, rtol=1e-4)
    assert abs(float(X[-1, 1])) < 1e-9 and abs(float(X[-1, 2])) < 1e-9


def test_bicycle_point_stab_reaches_goal():
    prob = make_bicycle_point_stabilization(PARAMS, horizon=30)
    theta = prob.make_theta(jnp.zeros(3), jnp.array([0.8, 0.3, 0.3]))
    sol = jax.jit(prob.solve)(theta, prob.default_u0)
    assert bool(sol.converged), f"kkt={float(sol.kkt_residual):.2e}"
    # steering stays inside its box
    u = np.asarray(sol.U)
    assert (np.abs(u[:, 1]) <= 0.45 + 1e-6).all()
    assert float(jnp.linalg.norm(sol.X[-1, :2] - theta["goal"][:2])) < 0.15


def test_bicycle_avoids_obstacle():
    prob = make_bicycle_point_stabilization(PARAMS, horizon=30)
    n = PARAMS.n_obstacle_points
    obs_x = np.full(n, 100.0)
    obs_y = np.full(n, 100.0)
    obs_x[0], obs_y[0] = 0.4, 0.0  # on the straight line to the goal
    theta = prob.make_theta(jnp.zeros(3), jnp.array([0.8, 0.0, 0.0]),
                            jnp.asarray(obs_x), jnp.asarray(obs_y))
    sol = jax.jit(prob.solve)(theta, prob.default_u0)
    clear = np.min(np.hypot(np.asarray(sol.X[:, 0]) - 0.4, np.asarray(sol.X[:, 1])))
    assert clear > 0.1, f"trajectory passes {clear:.3f} m from the obstacle"


def test_smooth_point_stab_parks_with_bounded_accel():
    prob = make_smooth_point_stabilization(PARAMS, horizon=40)
    x0 = jnp.zeros(5)
    theta = prob.make_theta(x0, jnp.array([0.6, 0.2, 0.0]))
    sol = jax.jit(prob.solve)(theta, prob.default_u0)
    assert bool(sol.converged), f"kkt={float(sol.kkt_residual):.2e}"
    X, U = np.asarray(sol.X), np.asarray(sol.U)
    # parks: terminal pose near goal AND terminal velocities near zero
    assert np.linalg.norm(X[-1, :2] - [0.6, 0.2]) < 0.1
    assert np.abs(X[-1, 3:5]).max() < 0.05
    # accelerations respect the box
    assert (U[:, 0] >= -0.3 - 1e-6).all() and (U[:, 0] <= 0.3 + 1e-6).all()
    # intrinsic rate limiting: consecutive velocities differ by <= a_max*dt
    dv = np.abs(np.diff(X[:, 3]))
    assert dv.max() <= 0.3 * PARAMS.dt + 1e-6
    # soft velocity limit holds (up to hinge softness)
    assert np.abs(X[:, 3]).max() < 0.2 + 0.02


def test_smooth_model_composes_with_mppi_and_hybrid():
    """The second solver family is model-generic too."""
    from ros2_mpc_jax.solver import MppiSettings, make_hybrid_solver

    prob = make_smooth_point_stabilization(PARAMS, horizon=16)
    theta = prob.make_theta(jnp.zeros(5), jnp.array([0.4, -0.2, 0.0]))
    hyb = jax.jit(make_hybrid_solver(prob.ocp, prob.settings,
                                     MppiSettings(n_samples=32, n_iters=4)))
    sol_h = hyb(theta, prob.default_u0, jax.random.PRNGKey(0))
    sol_p = jax.jit(prob.solve)(theta, prob.default_u0)
    assert float(sol_h.cost) <= float(sol_p.cost) + 1e-5


def test_new_kinds_shard_with_vmap_engine_and_reject_specialized():
    from ros2_mpc_jax.parallel import make_bank_solver, make_mesh, shard_bank

    prob = make_bicycle_point_stabilization(PARAMS, horizon=8)
    rng = np.random.default_rng(0)
    B = 16
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.2, 0.2, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3))),
    )
    U0 = jnp.zeros((B,) + prob.default_u0.shape)
    mesh = make_mesh()
    step = make_bank_solver(prob, mesh, engine="vmap")
    sols, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert len(sols.U.sharding.device_set) == 8
    assert np.isfinite(float(metrics["mean_cost"]))

    # the generic lane-aligned engine shards these kinds too (per-device
    # batch B/8 = 2 lanes here); only the Pallas kernels reject
    step_f = make_bank_solver(prob, mesh, engine="fast", lanes=2)
    sols_f, _ = step_f(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    np.testing.assert_allclose(np.asarray(sols_f.U), np.asarray(sols.U), atol=1e-3)
    with pytest.raises(ValueError, match="unicycle structure"):
        make_bank_solver(prob, mesh, engine="pallas")

    from ros2_mpc_jax.parallel.fleet import make_fleet_rollout

    with pytest.raises(ValueError, match="point_stabilization"):
        make_fleet_rollout(prob, n_ticks=2, dt=PARAMS.dt)


def test_sweep_runs_on_new_model_families():
    """Monte-Carlo tuning sweeps are model-generic through the vmap engine:
    the same SweepSpec grid runs on the bicycle and the smooth-actuation
    unicycle (extra velocity states start at zero)."""
    from ros2_mpc_jax.parallel import SweepSpec, make_mesh, run_sweep
    from ros2_mpc_jax.solver.ilqr import SolverSettings

    spec = SweepSpec(q_scales=(0.5, 2.0), r_scales=(1.0,), scenarios_per_config=4)
    fast = SolverSettings(barrier_stages=3, iters_per_stage=3, n_alphas=6)
    mesh = make_mesh()
    for make in (make_bicycle_point_stabilization, make_smooth_point_stabilization):
        prob = make(PARAMS, horizon=6, settings=fast)
        out = run_sweep(prob, spec, mesh=mesh, engine="vmap")
        assert out["mean_goal_error"].shape == (2,)
        assert np.isfinite(out["mean_goal_error"]).all()


def test_quadrotor_hover_is_dynamics_fixed_point():
    """The analytic hover input (m g, 0, 0, 0) holds any level zero-rate
    pose exactly (models/quadrotor.py contract)."""
    from ros2_mpc_jax.models import quadrotor
    from ros2_mpc_jax.ops.integrators import make_step

    F = make_step(quadrotor.make_f(), "rk4", 0.05)
    x = jnp.array([1.0, -2.0, 3.0, 0, 0, 0, 0, 0, 0.7, 0, 0, 0])
    x1 = F(x, quadrotor.hover_control())
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x), atol=1e-6)
    # free fall without thrust: zdot after one step ~ -g*dt
    x2 = F(x, jnp.zeros(4))
    assert float(x2[5]) == pytest.approx(-9.81 * 0.05, rel=1e-3)


def test_quadrotor_hover_solver_flies_to_pose():
    """The generic iLQR stabilizes the 12-state platform from a perturbed
    start (offset + tilt + rate): 16x16 stage quadratization, asymmetric
    4-dim control box, hover warm start."""
    from ros2_mpc_jax.solver import make_quadrotor_hover

    prob = make_quadrotor_hover(horizon=30)
    x0 = jnp.array([0.4, -0.3, -0.2, 0, 0, 0, 0.15, -0.1, 0.3, 0, 0, 0])
    goal = jnp.array([0.0, 0.0, 0.0, 0.0])
    theta = prob.make_theta(x0, goal)
    sol = jax.jit(prob.solve)(theta, prob.default_u0)
    X = np.asarray(sol.X)
    assert np.all(np.isfinite(X))
    # terminal state near the goal pose, level, slow
    assert np.linalg.norm(X[-1, 0:3]) < 0.08, X[-1, 0:3]
    assert np.linalg.norm(X[-1, 3:6]) < 0.15
    assert abs(X[-1, 6]) < 0.06 and abs(X[-1, 7]) < 0.06
    assert abs(X[-1, 8]) < 0.1
    # controls respect the physical box (thrust cannot pull)
    U = np.asarray(sol.U)
    assert U[:, 0].min() >= 0.0
    assert np.abs(U[:, 1:]).max() <= 0.02 + 1e-9
    assert bool(sol.converged) or float(sol.kkt_residual) < 1e-3


def test_quadrotor_bank_and_mesh_vmap_engine():
    """Scenario banks + mesh sharding compose unchanged for the 12-state
    family; the Pallas kernels reject it loudly."""
    from ros2_mpc_jax.parallel import make_bank_solver, make_mesh, shard_bank
    from ros2_mpc_jax.solver import make_quadrotor_hover

    prob = make_quadrotor_hover(horizon=12)
    B = 16
    rng = np.random.default_rng(2)
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = rng.uniform(-0.3, 0.3, size=(B, 3))
    x0[:, 6:8] = rng.uniform(-0.1, 0.1, size=(B, 2))
    goal = np.concatenate(
        [rng.uniform(-0.2, 0.2, size=(B, 3)), rng.uniform(-0.3, 0.3, size=(B, 1))],
        axis=1,
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.tile(prob.default_u0[None], (B, 1, 1))
    mesh = make_mesh()
    step = make_bank_solver(prob, mesh, engine="vmap")
    sols, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert np.all(np.isfinite(np.asarray(sols.U)))
    assert np.isfinite(float(metrics["mean_cost"]))
    with pytest.raises(ValueError, match="unicycle structure"):
        make_bank_solver(prob, mesh, engine="pallas")


def test_quadrotor_receding_horizon_closed_loop():
    """The full MPC loop on the 12-state family: solve, fly the first
    control on an RK4 plant, shift-warm-start, repeat — reaches and holds
    the goal pose (the pattern every follower node runs, on a platform the
    reference cannot express)."""
    from ros2_mpc_jax.models import quadrotor
    from ros2_mpc_jax.ops.integrators import make_step
    from ros2_mpc_jax.solver import SolverSettings, make_quadrotor_hover, shift_controls

    dt = 0.05
    prob = make_quadrotor_hover(
        horizon=20, dt=dt,
        settings=SolverSettings(barrier_stages=4, iters_per_stage=4, n_alphas=6,
                                mu_init=1e-2),
    )
    plant = make_step(quadrotor.make_f(), "rk4", dt)
    solve = jax.jit(prob.solve)
    goal = jnp.array([0.5, -0.4, 0.3, 0.0])
    x = jnp.array([0.0, 0.0, 0.0, 0, 0, 0, 0.1, -0.1, 0.4, 0, 0, 0])
    warm = prob.default_u0
    hover = quadrotor.hover_control()
    for _ in range(60):  # 3 s of flight
        sol = solve(prob.make_theta(x, goal), warm)
        u0 = jnp.where(jnp.isfinite(sol.U[0]), sol.U[0], hover)
        x = plant(x, u0)
        warm = shift_controls(sol.U)
    xf = np.asarray(x)
    assert np.all(np.isfinite(xf))
    assert np.linalg.norm(xf[0:3] - [0.5, -0.4, 0.3]) < 0.05, xf[0:3]
    assert np.linalg.norm(xf[3:6]) < 0.05  # hovering, not passing through
    assert abs(xf[6]) < 0.03 and abs(xf[7]) < 0.03  # level
