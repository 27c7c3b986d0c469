"""Model-generic lane-aligned bank engine (solver/batched.py).

Round-4 verdict item 1: the performance engines must not be a unicycle
special case. The lane-aligned engine's only model-specific piece was the
2x2 ``Quu`` closed form; with the unrolled component Cholesky it takes any
small-(n, m) OCP. These tests pin:

* the Cholesky solve itself against ``np.linalg.solve`` (sizes 3/4/6,
  SPD and safeguarded-indefinite);
* bank parity vs the ``jax.vmap`` correctness engine at <= 1e-3 for every
  ext model family (bicycle m=2 n=3, smooth m=2 n=5, quadrotor m=4 n=12 —
  the reference's CasADi layer was model-generic,
  ros2_mpc/planner/local_planner_tracking.py:161-178);
* the build-time batch-semantics probe rejecting a scalar-only transition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import (
    make_bicycle_point_stabilization,
    make_quadrotor_hover,
    make_smooth_point_stabilization,
)
from ros2_mpc_jax.solver.batched import _chol_solve, make_bank_solver_fast
from ros2_mpc_jax.solver.ilqr import OCP, SolverSettings

PARAMS = Params()


@pytest.mark.parametrize("m", [3, 4, 6])
def test_chol_solve_matches_dense(m):
    rng = np.random.default_rng(m)
    bs = (2, 3)
    n_rhs = 4
    A = rng.normal(size=bs + (m, m))
    M_dense = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(m)  # SPD per batch cell
    rhs_dense = rng.normal(size=bs + (m, n_rhs))
    want = np.linalg.solve(M_dense, rhs_dense)

    # component-stacked layout: (m, m, *bs) / (m, n_rhs, *bs)
    M = jnp.asarray(np.moveaxis(M_dense, (-2, -1), (0, 1)))
    rhs = jnp.asarray(np.moveaxis(rhs_dense, (-2, -1), (0, 1)))
    got = np.moveaxis(np.asarray(_chol_solve(M, rhs)), (0, 1), (-2, -1))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_chol_solve_safeguards_indefinite():
    """A non-PD matrix must take the same heavy diagonal loading as the 2x2
    path: finite answer equal to solving (M + 1e3 I)."""
    m = 4
    M_dense = -np.eye(m) + 0.01  # indefinite
    rhs_dense = np.arange(float(m)).reshape(m, 1)
    M = jnp.asarray(M_dense)[..., None, None]  # (m, m, 1, 1)
    rhs = jnp.asarray(rhs_dense)[..., None, None]
    got = np.asarray(_chol_solve(M, rhs))[..., 0, 0]
    want = np.linalg.solve(M_dense + 1e3 * np.eye(m), rhs_dense)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


def test_probe_rejects_scalar_only_transition():
    def bad_F(x, u):
        # scalar semantics: x[2] instead of x[..., 2] — silently wrong banks
        return jnp.stack([x[0] + u[0], x[1], x[2] + u[1]])

    ocp = OCP(
        transition=bad_F,
        stage_cost=lambda x, u, k, th: jnp.sum(x * x) + jnp.sum(u * u),
        terminal_cost=lambda x, th: 0.0,
        horizon=4,
        n_states=3,
        n_controls=2,
        u_lo=(-1.0, -1.0),
        u_hi=(1.0, 1.0),
    )
    with pytest.raises(ValueError, match="batched semantics"):
        make_bank_solver_fast(ocp, SolverSettings(), lanes=2)


def _bank_parity(prob, thetas, U0s, lanes, atol):
    fast = jax.jit(make_bank_solver_fast(prob.ocp, prob.settings, lanes=lanes))
    ref = jax.jit(jax.vmap(prob.solve))
    sf = jax.block_until_ready(fast(thetas, U0s))
    sv = jax.block_until_ready(ref(thetas, U0s))
    np.testing.assert_allclose(np.asarray(sf.U), np.asarray(sv.U), atol=atol)
    np.testing.assert_allclose(
        np.asarray(sf.cost), np.asarray(sv.cost), rtol=1e-4, atol=1e-5
    )
    assert np.asarray(sf.converged).mean() > 0.5
    return sf


def test_bicycle_bank_parity_fast_vs_vmap():
    prob = make_bicycle_point_stabilization(PARAMS, horizon=12)
    B = 16
    rng = np.random.default_rng(0)
    x0 = np.concatenate(
        [rng.uniform(-0.3, 0.3, (B, 2)), rng.uniform(-np.pi, np.pi, (B, 1))], axis=1
    )
    goal = np.concatenate(
        [rng.uniform(-0.8, 0.8, (B, 2)), rng.uniform(-np.pi, np.pi, (B, 1))], axis=1
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    _bank_parity(prob, thetas, jnp.zeros((B, 12, 2)), lanes=8, atol=1e-3)


def test_smooth_bank_parity_fast_vs_vmap():
    prob = make_smooth_point_stabilization(PARAMS, horizon=12)
    B = 16
    rng = np.random.default_rng(1)
    x0 = np.zeros((B, 5))
    x0[:, :2] = rng.uniform(-0.2, 0.2, (B, 2))
    x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    goal = np.concatenate(
        [rng.uniform(-0.6, 0.6, (B, 2)), rng.uniform(-np.pi, np.pi, (B, 1))], axis=1
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    _bank_parity(prob, thetas, jnp.zeros((B, 12, 2)), lanes=8, atol=1e-3)


def test_fast_polish_composite_generic():
    """The model-generic bank composite (make_fast_polish_solver): fast
    first pass + box-DDP KKT polish on the quadrotor bank must never worsen
    a row and must lift the converged fraction (bench.py's quadrotor_*
    cells measure the production configuration)."""
    from ros2_mpc_jax.solver import make_fast_polish_solver

    prob = make_quadrotor_hover(horizon=10, settings=SolverSettings.fast())
    B = 32
    rng = np.random.default_rng(5)
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 6:8] = rng.uniform(-0.15, 0.15, (B, 2))
    x0[:, 8] = rng.uniform(-0.5, 0.5, B)
    goal = np.concatenate(
        [rng.uniform(-0.3, 0.3, (B, 3)), rng.uniform(-0.4, 0.4, (B, 1))], axis=1
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.tile(prob.default_u0[None], (B, 1, 1))
    plain = jax.jit(make_bank_solver_fast(prob.ocp, prob.settings, lanes=8))
    comp = jax.jit(
        make_fast_polish_solver(prob.ocp, prob.settings, capacity=8, lanes=8)
    )
    sp = jax.block_until_ready(plain(thetas, U0))
    sc = jax.block_until_ready(comp(thetas, U0))
    assert np.all(
        np.asarray(sc.kkt_residual) <= np.asarray(sp.kkt_residual) + 1e-7
    )
    assert np.asarray(sc.converged).mean() >= np.asarray(sp.converged).mean()
    # unfused twin: identical numerics
    comp_u = make_fast_polish_solver(
        prob.ocp, prob.settings, capacity=8, lanes=8, fuse=False
    )
    su = comp_u(thetas, U0)
    np.testing.assert_allclose(np.asarray(su.U), np.asarray(sc.U), atol=1e-6)


def test_quadrotor_bank_parity_fast_vs_vmap():
    """The 12-state / 4-control family through the lane-aligned engine: the
    4x4 Quu solves route through the unrolled Cholesky; answers must match
    the vmap engine within the BASELINE tolerance."""
    prob = make_quadrotor_hover(horizon=10)
    B = 16
    rng = np.random.default_rng(2)
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 6:8] = rng.uniform(-0.15, 0.15, (B, 2))
    x0[:, 8] = rng.uniform(-0.5, 0.5, B)
    goal = np.concatenate(
        [rng.uniform(-0.3, 0.3, (B, 3)), rng.uniform(-0.4, 0.4, (B, 1))], axis=1
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.tile(prob.default_u0[None], (B, 1, 1))
    fast = jax.jit(make_bank_solver_fast(prob.ocp, prob.settings, lanes=8))
    ref = jax.jit(jax.vmap(prob.solve))
    sf = jax.block_until_ready(fast(thetas, U0))
    sv = jax.block_until_ready(ref(thetas, U0))
    # control scales differ 500x across channels (thrust ~9.8 N vs torque
    # <= 0.02 N m): compare per channel at 1e-3 of the channel's box width
    width = np.asarray(prob.ocp.u_hi) - np.asarray(prob.ocp.u_lo)
    err = np.abs(np.asarray(sf.U) - np.asarray(sv.U)) / width[None, None, :]
    assert err.max() < 1e-3, f"relative control error {err.max():.2e}"
    np.testing.assert_allclose(
        np.asarray(sf.cost), np.asarray(sv.cost), rtol=1e-4, atol=1e-5
    )


def test_generic_fleet_quadrotor_reaches_hover():
    """The generic closed-loop fleet evaluator (parallel/fleet.py::
    make_generic_fleet_rollout): a 12-state quadrotor fleet flies
    solve-actuate-shift to per-robot goal poses through the generic bank
    engine — the fleet-scale capability for every model family."""
    from ros2_mpc_jax.parallel import make_generic_fleet_rollout

    dt = 0.05
    prob = make_quadrotor_hover(
        horizon=16, dt=dt,
        settings=SolverSettings(barrier_stages=4, iters_per_stage=4, n_alphas=6,
                                mu_init=1e-2),
    )
    B = 16
    rng = np.random.default_rng(9)
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = rng.uniform(-0.3, 0.3, (B, 3))
    x0[:, 8] = rng.uniform(-0.4, 0.4, B)
    goal = np.concatenate(
        [rng.uniform(-0.4, 0.4, (B, 3)), rng.uniform(-0.3, 0.3, (B, 1))], axis=1
    )
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.tile(prob.default_u0[None], (B, 1, 1))
    roll = make_generic_fleet_rollout(prob, n_ticks=50, goal_threshold=0.1, lanes=8)
    out = roll(thetas, U0)
    assert np.all(np.isfinite(np.asarray(out.final_states)))
    assert float(out.reach_fraction) >= 0.9, float(out.mean_dist)
    # hovering at the goal, not flying through: terminal velocities small
    assert np.abs(np.asarray(out.final_states)[:, 3:6]).max() < 0.2


def test_generic_fleet_rejects_tracking():
    from ros2_mpc_jax.parallel import make_generic_fleet_rollout
    from ros2_mpc_jax.solver import make_tracking

    prob = make_tracking(PARAMS, horizon=8)
    with pytest.raises(ValueError, match="tracking"):
        make_generic_fleet_rollout(prob, n_ticks=2)
