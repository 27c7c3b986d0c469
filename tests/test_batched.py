"""The lane-aligned bank engine must agree with the vmapped reference solver
on every problem family (same algorithm, different layout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import (
    SolverSettings,
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_tracking,
)
from ros2_mpc_jax.solver.batched import make_bank_solver_fast

PARAMS = Params()
N = 10
FAST = SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
LANES = 8  # small lane count so tests stay light; 128 in production


def _point_bank(prob, B, seed=0):
    rng = np.random.default_rng(seed)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.2, 1.2, size=(B, 3))),
    )
    return thetas, jnp.zeros((B, N, 2))


def test_bank_engine_matches_vmap_point_stab():
    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    B = 16
    thetas, U0 = _point_bank(prob, B)
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    fast = jax.jit(make_bank_solver_fast(prob.ocp, FAST, lanes=LANES))(thetas, U0)
    np.testing.assert_allclose(np.asarray(fast.U), np.asarray(ref.U), atol=2e-5)
    np.testing.assert_allclose(np.asarray(fast.cost), np.asarray(ref.cost), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(fast.X), np.asarray(ref.X), atol=2e-5)


def test_bank_engine_matches_vmap_tracking():
    prob = make_tracking(PARAMS, horizon=N, settings=FAST)
    B = 8
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack(
        [x0[:, 0:1] + 0.15 * ts[None], np.zeros((B, N)), np.zeros((B, N))], axis=2
    )
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref))
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    fast = jax.jit(make_bank_solver_fast(prob.ocp, FAST, lanes=LANES))(thetas, U0)
    np.testing.assert_allclose(np.asarray(fast.U), np.asarray(ref.U), atol=2e-5)


def test_bank_engine_matches_vmap_legacy_obstacles():
    prob = make_legacy_point_stabilization(PARAMS, horizon=N, settings=FAST)
    B = 8
    rng = np.random.default_rng(2)
    n_obs = PARAMS.n_obstacle_points
    obs_x = np.full((B, n_obs), 100.0)
    obs_y = np.full((B, n_obs), 100.0)
    obs_x[:, 0] = rng.uniform(0.3, 0.6, size=B)
    obs_y[:, 0] = rng.uniform(-0.2, 0.2, size=B)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.1, 0.1, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3))),
        jnp.asarray(obs_x),
        jnp.asarray(obs_y),
    )
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    fast = jax.jit(make_bank_solver_fast(prob.ocp, FAST, lanes=LANES))(thetas, U0)
    np.testing.assert_allclose(np.asarray(fast.U), np.asarray(ref.U), atol=5e-5)


def test_bank_engine_rejects_bad_batch():
    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    thetas, U0 = _point_bank(prob, 12)  # not a multiple of LANES=8
    with pytest.raises(AssertionError):
        make_bank_solver_fast(prob.ocp, FAST, lanes=LANES)(thetas, U0)
