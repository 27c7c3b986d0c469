"""Parallel (associative-scan) LQR backward pass vs the sequential recursion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.solver.parallel_riccati import (
    LQRProblem,
    lqr_backward_parallel,
    lqr_backward_sequential,
)


def random_lqr(N, n=3, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(n) + 0.05 * rng.standard_normal((n, n)) for _ in range(N)])
    B = 0.2 * rng.standard_normal((N, n, m))
    lxx = []
    luu = []
    for _ in range(N):
        Mx = rng.standard_normal((n, n))
        lxx.append(Mx @ Mx.T * 0.1 + 0.5 * np.eye(n))
        Mu = rng.standard_normal((m, m))
        luu.append(Mu @ Mu.T * 0.1 + 1.0 * np.eye(m))
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx = rng.standard_normal((N, n))
    lu = rng.standard_normal((N, m))
    PT = np.eye(n) * 2.0
    pT = rng.standard_normal(n)
    return LQRProblem(
        A=jnp.asarray(A), B=jnp.asarray(B),
        lxx=jnp.asarray(np.stack(lxx)), lux=jnp.asarray(lux), luu=jnp.asarray(np.stack(luu)),
        lx=jnp.asarray(lx), lu=jnp.asarray(lu),
        P_N=jnp.asarray(PT), p_N=jnp.asarray(pT),
    )


@pytest.mark.parametrize("N", [4, 31, 128])
def test_parallel_matches_sequential(N):
    prob = random_lqr(N, seed=N)
    seq = jax.jit(lqr_backward_sequential)(prob)
    par = jax.jit(lqr_backward_parallel)(prob)
    np.testing.assert_allclose(np.asarray(par.P), np.asarray(seq.P), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(par.p), np.asarray(seq.p), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(par.kff), np.asarray(seq.kff), rtol=2e-3, atol=2e-3)


def test_policies_minimize_the_qp():
    """Rolling out du = -K dx - kff from dx0=0 must beat small perturbations
    of the controls on the quadratic objective."""
    N = 16
    prob = random_lqr(N, seed=7)
    gains = lqr_backward_parallel(prob)

    def cost_of(du_seq):
        dx = jnp.zeros(3)
        J = 0.0
        for k in range(N):
            du = du_seq[k]
            J = J + 0.5 * dx @ prob.lxx[k] @ dx + prob.lx[k] @ dx
            J = J + 0.5 * du @ prob.luu[k] @ du + prob.lu[k] @ du + du @ prob.lux[k] @ dx
            dx = prob.A[k] @ dx + prob.B[k] @ du
        return J + 0.5 * dx @ prob.P_N @ dx + prob.p_N @ dx

    def rollout_policy():
        dx = jnp.zeros(3)
        dus = []
        for k in range(N):
            du = -gains.K[k] @ dx - gains.kff[k]
            dus.append(du)
            dx = prob.A[k] @ dx + prob.B[k] @ du
        return jnp.stack(dus)

    du_opt = rollout_policy()
    J_opt = float(cost_of(du_opt))
    rng = np.random.default_rng(3)
    for _ in range(5):
        J_pert = float(cost_of(du_opt + 0.01 * rng.standard_normal(du_opt.shape)))
        assert J_opt <= J_pert + 1e-6


def test_solver_with_horizon_parallel_backward():
    """settings.horizon_parallel routes the inner sweep through the
    associative scan; solutions must match the sequential solver."""
    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization

    P = Params()
    N = 16
    seq_prob = make_point_stabilization(
        P, horizon=N, settings=SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
    )
    par_prob = make_point_stabilization(
        P, horizon=N,
        settings=SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6, horizon_parallel=True),
    )
    theta = seq_prob.make_theta(np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.8, 0.5]))
    s1 = jax.jit(seq_prob.solve)(theta, seq_prob.default_u0)
    s2 = jax.jit(par_prob.solve)(theta, par_prob.default_u0)
    np.testing.assert_allclose(np.asarray(s2.U), np.asarray(s1.U), atol=5e-4)
    np.testing.assert_allclose(float(s2.cost), float(s1.cost), rtol=1e-4)
