"""MPPI sampling engine + hybrid global/local solve (solver/mppi.py).

The engines share the Solution contract, so MPPI answers are compared on the
same true-cost / projected-gradient-KKT scale as the iLQR engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import make_point_stabilization, make_tracking
from ros2_mpc_jax.solver.mppi import MppiSettings, make_hybrid_solver, make_mppi_solver

PARAMS = Params()


def _point_stab(horizon=20, parity=False):
    return make_point_stabilization(PARAMS, horizon=horizon, reference_parity=parity)


def test_mppi_matches_ilqr_cost_point_stab():
    """Open-floor drive-to-pose: the sampled optimum must land within a few
    percent of the Newton optimum (smooth convex-ish landscape)."""
    prob = _point_stab()
    theta = prob.make_theta(jnp.array([0.0, 0.0, 0.0]), jnp.array([0.35, 0.15, 0.4]))
    mppi = jax.jit(make_mppi_solver(prob.ocp, MppiSettings(n_samples=192, n_iters=20)))
    sol_m = mppi(theta, prob.default_u0, jax.random.PRNGKey(0))
    sol_i = jax.jit(prob.solve)(theta, prob.default_u0)
    assert bool(sol_i.converged)
    assert float(sol_m.cost) <= 1.05 * float(sol_i.cost) + 1e-6
    # it drives essentially the Newton-optimal approach: terminal position
    # error within a small margin of the iLQR optimum's own
    d_m = float(jnp.linalg.norm(sol_m.X[-1, :2] - theta["goal"][:2]))
    d_i = float(jnp.linalg.norm(sol_i.X[-1, :2] - theta["goal"][:2]))
    assert d_m <= d_i + 0.05


def test_mppi_deterministic_given_key():
    prob = _point_stab()
    theta = prob.make_theta(jnp.zeros(3), jnp.array([0.3, -0.2, 0.0]))
    mppi = jax.jit(make_mppi_solver(prob.ocp, MppiSettings(n_samples=64, n_iters=6)))
    a = mppi(theta, prob.default_u0, jax.random.PRNGKey(7))
    b = mppi(theta, prob.default_u0, jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(a.U), np.asarray(b.U))
    c = mppi(theta, prob.default_u0, jax.random.PRNGKey(8))
    assert not np.array_equal(np.asarray(a.U), np.asarray(c.U))


def test_mppi_respects_bounds():
    prob = _point_stab()
    theta = prob.make_theta(jnp.zeros(3), jnp.array([1.5, 0.0, 0.0]))
    mppi = jax.jit(make_mppi_solver(prob.ocp, MppiSettings(n_samples=64, n_iters=8)))
    sol = mppi(theta, prob.default_u0, jax.random.PRNGKey(3))
    u = np.asarray(sol.U)
    lo, hi = np.asarray(prob.ocp.u_lo), np.asarray(prob.ocp.u_hi)
    assert (u >= lo - 1e-7).all() and (u <= hi + 1e-7).all()


def test_mppi_tracking_formulation():
    """The engine is formulation-generic: tracking OCP, straight-line ref."""
    prob = make_tracking(PARAMS, horizon=16)
    N = prob.ocp.horizon
    ts = (np.arange(1, N + 1) * PARAMS.dt)[:, None]
    x_ref = np.concatenate([0.1 * ts, np.zeros((N, 2))], axis=1)
    u_ref = np.concatenate([np.full((N, 1), 0.1), np.zeros((N, 1))], axis=1)
    theta = prob.make_theta(jnp.zeros(3), jnp.asarray(x_ref), jnp.asarray(u_ref))
    mppi = jax.jit(make_mppi_solver(prob.ocp, MppiSettings(n_samples=192, n_iters=20)))
    sol_m = mppi(theta, prob.default_u0, jax.random.PRNGKey(1))
    sol_i = jax.jit(prob.solve)(theta, prob.default_u0)
    assert float(sol_m.cost) <= 1.10 * float(sol_i.cost) + 1e-6


@pytest.mark.slow
def test_hybrid_never_worse_and_lifts_convergence():
    """On an obstacle-cluttered bank the hybrid must (a) never lose to the
    plain iLQR on cost and (b) converge at least as many scenarios."""
    prob = _point_stab()
    rng = np.random.default_rng(11)
    B = 12
    n = PARAMS.n_obstacle_points
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.2, 1.2, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1
    )
    obs_x = np.full((B, n), 100.0)
    obs_y = np.full((B, n), 100.0)
    # a 3-point obstacle wall straddling each start-goal midpoint
    mid = (x0[:, :2] + goal[:, :2]) / 2
    seg = goal[:, :2] - x0[:, :2]
    perp = np.stack([-seg[:, 1], seg[:, 0]], axis=1)
    perp /= np.linalg.norm(perp, axis=1, keepdims=True) + 1e-9
    for j, off in enumerate((-0.12, 0.0, 0.12)):
        obs_x[:, j] = mid[:, 0] + off * perp[:, 0]
        obs_y[:, j] = mid[:, 1] + off * perp[:, 1]
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(goal), jnp.asarray(obs_x), jnp.asarray(obs_y)
    )
    U0 = jnp.zeros((B, prob.ocp.horizon, 2))
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    hybrid = jax.jit(jax.vmap(make_hybrid_solver(prob.ocp, prob.settings)))
    plain = jax.jit(jax.vmap(prob.solve))
    sol_h = hybrid(thetas, U0, keys)
    sol_p = plain(thetas, U0)
    conv_h = np.asarray(sol_h.converged)
    conv_p = np.asarray(sol_p.converged)
    assert conv_h.sum() >= conv_p.sum()
    both = conv_h & conv_p
    assert (np.asarray(sol_h.cost)[both] <= np.asarray(sol_p.cost)[both] + 1e-5).all()


def test_packed_hybrid_matches_direct():
    """The packed-theta wrapper forwards the PRNG key and reproduces the
    direct hybrid solve exactly (same theta, same key)."""
    from ros2_mpc_jax.solver.packed import make_packed_point_stab

    prob = _point_stab(horizon=10)
    hybrid = make_hybrid_solver(prob.ocp, prob.settings, MppiSettings(n_samples=32, n_iters=4))
    solve_pk, pack = make_packed_point_stab(prob, PARAMS, solve_fn=hybrid)
    n = PARAMS.n_obstacle_points
    x0 = np.array([0.1, -0.1, 0.3])
    goal = np.array([0.8, 0.4, 0.0])
    obs = np.full(n, 100.0)
    key = jax.random.PRNGKey(5)
    sol_pk, u_next = jax.jit(solve_pk)(pack(x0, goal, obs, obs), prob.default_u0, key)
    theta = prob.make_theta(jnp.asarray(x0, jnp.float32), jnp.asarray(goal, jnp.float32),
                            jnp.asarray(obs, jnp.float32), jnp.asarray(obs, jnp.float32))
    sol_d = jax.jit(hybrid)(theta, prob.default_u0, key)
    np.testing.assert_allclose(np.asarray(sol_pk.U), np.asarray(sol_d.U), atol=1e-6)
    # warm start is the shifted solution, produced inside the same jit
    np.testing.assert_allclose(np.asarray(u_next[:-1]), np.asarray(sol_d.U[1:]), atol=1e-6)


@pytest.mark.slow
def test_point_follower_escape_recovery():
    """escape_after wiring: a (forced) stall triggers exactly one hybrid
    escape tick, the command stays finite, and the robot still reaches the
    goal afterwards."""
    from ros2_mpc_jax.nodes.launch import build_sim_stack

    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12,
        follower_kwargs=dict(escape_after=3),
    )
    node = stack.follower
    stack.publish_goal(0.4, -1.6)
    stack.global_planner.tick()
    out = stack.tick()
    assert out["control"].get("escaped") is False
    node._stall = 99  # force the stall detector past the threshold
    out = stack.tick()
    assert out["control"]["escaped"] is True
    assert node.n_escapes == 1
    assert np.all(np.isfinite(out["control"]["u"]))
    assert node._stall in (0, 1)  # reset by the escape (+1 if it missed tol)
    reached = False
    for _ in range(250):
        o = stack.tick()
        if o["control"].get("status") == "goal_reached":
            reached = True
            break
    assert reached


def test_multistart_breaks_symmetric_saddle():
    """Obstacle dead-center on the start-goal line: the gradient cannot
    break the y-symmetry, so the plain iLQR hovers; sampling alone cannot
    bridge the distance either. The multi-start engine's arc seeds must
    find the detour basin and beat the plain solve decisively."""
    from ros2_mpc_jax.solver import make_multistart_solver

    prob = _point_stab(horizon=40)
    n = PARAMS.n_obstacle_points
    obs_x = np.full(n, 100.0)
    obs_y = np.full(n, 100.0)
    obs_x[0], obs_y[0] = 0.5, 0.0
    theta = prob.make_theta(
        jnp.zeros(3), jnp.array([1.0, 0.0, 0.0]),
        jnp.asarray(obs_x), jnp.asarray(obs_y),
    )
    theta = dict(theta)
    theta["Q"] = jnp.array([5.0, 5.0, 0.05])  # make reaching pay

    sol_p = jax.jit(prob.solve)(theta, prob.default_u0)
    ms = jax.jit(make_multistart_solver(
        prob.ocp, prob.settings, MppiSettings(n_samples=64, n_iters=6)
    ))
    sol_m = ms(theta, prob.default_u0, jax.random.PRNGKey(0))

    X_p, X_m = np.asarray(sol_p.X), np.asarray(sol_m.X)
    # plain: pinned to the symmetry axis, never near the goal
    assert np.abs(X_p[:, 1]).max() < 1e-3
    assert np.linalg.norm(X_p[:, :2] - [1.0, 0.0], axis=1).min() > 0.5
    # multistart: swings off-axis, approaches the goal, clears the obstacle
    assert bool(sol_m.converged)
    assert float(sol_m.cost) < 0.8 * float(sol_p.cost)
    assert np.linalg.norm(X_m[:, :2] - [1.0, 0.0], axis=1).min() < 0.25
    assert np.hypot(X_m[:, 0] - 0.5, X_m[:, 1]).min() > 0.1


def test_multistart_never_worse_on_open_floor():
    """No obstacle, convex-ish landscape: multistart must simply reproduce
    (or marginally beat) the plain solve — the warm start is one of its
    polished candidates."""
    from ros2_mpc_jax.solver import make_multistart_solver

    prob = _point_stab()
    theta = prob.make_theta(jnp.zeros(3), jnp.array([0.4, 0.25, 0.5]))
    sol_p = jax.jit(prob.solve)(theta, prob.default_u0)
    ms = jax.jit(make_multistart_solver(
        prob.ocp, prob.settings, MppiSettings(n_samples=32, n_iters=3)
    ))
    sol_m = ms(theta, prob.default_u0, jax.random.PRNGKey(1))
    assert float(sol_m.cost) <= float(sol_p.cost) + 1e-5
    assert bool(sol_m.converged) >= bool(sol_p.converged)


def test_multistart_generalizes_to_bicycle():
    """Arc seeds are built from the control box alone, so the engine works
    on any 2-control platform (here: Ackermann steering)."""
    from ros2_mpc_jax.solver import make_bicycle_point_stabilization, make_multistart_solver

    prob = make_bicycle_point_stabilization(PARAMS, horizon=24)
    theta = prob.make_theta(jnp.zeros(3), jnp.array([0.7, 0.2, 0.0]))
    ms = jax.jit(make_multistart_solver(
        prob.ocp, prob.settings, MppiSettings(n_samples=32, n_iters=3)
    ))
    sol = ms(theta, prob.default_u0, jax.random.PRNGKey(2))
    assert bool(sol.converged)
    u = np.asarray(sol.U)
    lo, hi = np.asarray(prob.ocp.u_lo), np.asarray(prob.ocp.u_hi)
    assert (u >= lo - 1e-6).all() and (u <= hi + 1e-6).all()


def test_selection_semantics_nan_and_nonconverged():
    """Ranking regressions (self-review round 3): among all-non-converged
    candidates the LOWEST COST must win (a 1e30 penalty swamps the f32 cost
    tiebreak and degenerates argmin to index 0), and a NaN cost must never
    win over a finite one."""
    from ros2_mpc_jax.solver.ilqr import Solution
    from ros2_mpc_jax.solver.mppi import _prefer_first, _select_best

    def bank(cost, conv):
        k = len(cost)
        return Solution(
            U=jnp.zeros((k, 2, 2)), X=jnp.zeros((k, 3, 3)),
            cost=jnp.asarray(cost), kkt_residual=jnp.zeros(k),
            converged=jnp.asarray(conv), n_iters=jnp.zeros(k, jnp.int32),
            reg=jnp.zeros(k),
        )

    assert int(_select_best(bank([500.0, 3.0, 80.0], [False] * 3))) == 1
    assert int(_select_best(bank([np.nan, 2.0], [True, True]))) == 1
    assert int(_select_best(bank([1.0, 50.0], [False, True]))) == 1

    def one(c, v):
        return Solution(U=0, X=0, cost=jnp.asarray(c), kkt_residual=0,
                        converged=jnp.asarray(v), n_iters=0, reg=0)

    assert not bool(_prefer_first(one(np.nan, True), one(5.0, True)))
    assert bool(_prefer_first(one(2.0, True), one(5.0, True)))
    assert bool(_prefer_first(one(5.0, True), one(2.0, False)))
    assert not bool(_prefer_first(one(3.0, True), one(3.0, True)))  # tie -> plain


@pytest.mark.slow
def test_tracking_follower_escape_recovery():
    """escape_after on the tracking follower: a (forced) stall triggers one
    multi-start escape on the tracking OCP; the run still reaches the goal."""
    from ros2_mpc_jax.nodes.launch import build_sim_stack

    stack = build_sim_stack(
        follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=12,
        follower_kwargs=dict(escape_after=3),
    )
    node = stack.follower
    stack.publish_goal(1.0, -1.0)
    stack.global_planner.tick()
    out = stack.tick()
    assert out["control"].get("escaped") is False
    node._stall = 99
    out = stack.tick()
    assert out["control"]["escaped"] is True
    assert node.n_escapes == 1
    assert np.all(np.isfinite(out["control"]["u"]))
    reached = False
    for _ in range(300):
        o = stack.tick()
        if o["control"].get("status") == "goal_reached":
            reached = True
            break
    assert reached
