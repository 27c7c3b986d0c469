"""MPPI: sampling-based NMPC engine + hybrid global/local solve.

A second solver family next to the interior-point iLQR (solver/ilqr.py). The
reference has exactly one solver (CasADi Opti -> IPOPT at
ros2_mpc/planner/local_planner_tracking.py:74 etc.) and therefore inherits
IPOPT's failure mode on nonconvex landscapes: a bad initialization lands in a
poor basin (or raises). Model-Predictive Path Integral control is the
derivative-free complement — a softmin-weighted average over thousands of
perturbed control rollouts:

    U <- sum_i w_i (U + eps_i) / sum_i w_i,   w_i = exp(-(J_i - min J) / T)

It needs only the cost (no gradients, no Hessians, no smoothness), explores
globally, and is embarrassingly parallel: each iteration is one
``vmap``-batched ``lax.scan`` rollout of ``n_samples`` candidates — pure
elementwise work with zero cross-sample communication, so it batches
cleanly and shards over scenario meshes like every other engine.

Two entry points:

* :func:`make_mppi_solver` — standalone MPPI on any :class:`~.ilqr.OCP`
  (both live formulations work; the engine touches only ``transition`` /
  ``stage_cost`` / ``terminal_cost`` and the box bounds).
* :func:`make_hybrid_solver` — MPPI exploration seeding the iLQR polish:
  sampling finds the right basin on obstacle-cluttered landscapes where a
  cold-started Newton method stalls, then the interior-point iLQR converges
  it to KKT tolerance. Measured on adversarial obstacle banks this lifts the
  converged fraction above either engine alone (tests/test_mppi.py).

Sampling uses time-correlated (AR(1)-filtered) Gaussian noise — white noise
in the control sequence excites chatter the unicycle cannot execute; the
filter concentrates exploration energy in the low frequencies that matter
for a 0.2 s-per-step horizon.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .ilqr import OCP, Solution, SolverSettings, make_solver


@dataclasses.dataclass(frozen=True)
class MppiSettings:
    """Fixed-shape MPPI schedule (static under jit)."""

    n_samples: int = 256  # rollouts per iteration
    n_iters: int = 16  # mean-update iterations
    temperature: float = 0.02  # softmin temperature on (J - J_min)
    sigma_frac: float = 0.25  # exploration std as a fraction of (hi - lo)
    smooth_beta: float = 0.6  # AR(1) noise correlation along the horizon
    sigma_decay: float = 0.92  # per-iteration annealing of the exploration std
    # Solution.converged semantics: MPPI is a global-search engine, not a KKT
    # polisher; "converged" means the projected-gradient residual reached the
    # (loose) sampling tolerance. Use the hybrid solver for tight KKT.
    kkt_tol: float = 1e-2


def _ar1_noise(key, n_samples: int, N: int, m: int, beta: float) -> jnp.ndarray:
    """(n_samples, N, m) standard-normal noise, AR(1)-correlated along N with
    unit marginal variance: e_k = beta e_{k-1} + sqrt(1-beta^2) n_k."""
    white = jax.random.normal(key, (N, n_samples, m))

    def body(carry, n_k):
        e = beta * carry + jnp.sqrt(1.0 - beta * beta) * n_k
        return e, e

    _, eps = jax.lax.scan(body, white[0], white[1:])
    eps = jnp.concatenate([white[:1], eps], axis=0)  # e_0 = n_0
    return jnp.moveaxis(eps, 1, 0)  # (n_samples, N, m)


def make_mppi_solver(ocp: OCP, settings: MppiSettings = MppiSettings()):
    """Build ``solve(theta, U0, key) -> Solution``.

    Pure and jit/vmap/pjit-composable; add the scenario axis with
    ``jax.vmap(solve, in_axes=(0, 0, 0))`` (split the key per scenario).
    The returned ``Solution`` reports the true objective and the same
    projected-gradient KKT residual as the iLQR engines, so engines are
    directly comparable on one scale.
    """
    N, m = ocp.horizon, ocp.n_controls
    u_lo = jnp.asarray(ocp.u_lo)
    u_hi = jnp.asarray(ocp.u_hi)
    sigma0 = settings.sigma_frac * (u_hi - u_lo)
    ks = jnp.arange(N)
    F = ocp.transition

    def rollout_cost(U, theta):
        def body(carry, inp):
            x, acc = carry
            u, k = inp
            acc = acc + ocp.stage_cost(x, u, k, theta)
            return (F(x, u), acc), x

        (xN, acc), X_prefix = jax.lax.scan(body, (theta["x0"], 0.0), (U, ks))
        return acc + ocp.terminal_cost(xN, theta), jnp.concatenate([X_prefix, xN[None]], 0)

    cost_of = lambda U, theta: rollout_cost(U, theta)[0]

    def solve(theta, U0, key):
        U0 = jnp.clip(jnp.asarray(U0, jnp.result_type(float)), u_lo, u_hi)
        J0 = cost_of(U0, theta)

        def iteration(carry, key_t):
            U, J_best, U_best, it = carry
            sigma = sigma0 * settings.sigma_decay**it
            eps = _ar1_noise(key_t, settings.n_samples, N, m, settings.smooth_beta)
            cands = jnp.clip(U[None] + sigma[None, None] * eps, u_lo, u_hi)
            # the current mean always competes (guards the weighted update
            # against a round where every perturbation is worse)
            cands = jnp.concatenate([U[None], cands], axis=0)
            Js = jax.vmap(cost_of, in_axes=(0, None))(cands, theta)
            Js = jnp.where(jnp.isnan(Js), jnp.inf, Js)
            J_min = jnp.min(Js)
            w = jnp.exp(-(Js - J_min) / settings.temperature)
            w = w / jnp.sum(w)
            U_new = jnp.clip(jnp.einsum("s,snm->nm", w, cands), u_lo, u_hi)
            # running elite: the single best sampled sequence ever seen
            i_min = jnp.argmin(Js)
            better = J_min < J_best
            U_best = jnp.where(better, cands[i_min], U_best)
            J_best = jnp.where(better, J_min, J_best)
            return (U_new, J_best, U_best, it + 1), None

        keys = jax.random.split(key, settings.n_iters)
        (U_mean, J_best, U_best, _), _ = jax.lax.scan(
            iteration, (U0, J0, U0, 0), keys
        )
        # final answer: the better of the weighted mean and the running elite
        J_mean = cost_of(U_mean, theta)
        take_mean = J_mean <= J_best
        U_fin = jnp.where(take_mean, U_mean, U_best)
        J_fin, X_fin = rollout_cost(U_fin, theta)
        g = jax.grad(cost_of)(U_fin, theta)
        kkt = jnp.max(jnp.abs(U_fin - jnp.clip(U_fin - g, u_lo, u_hi)))
        return Solution(
            U=U_fin,
            X=X_fin,
            cost=J_fin,
            kkt_residual=kkt,
            converged=kkt < settings.kkt_tol,
            n_iters=jnp.asarray(settings.n_iters, jnp.int32),
            reg=jnp.zeros(()),
        )

    return solve


def _sanitize_cost(cost):
    """NaN costs lose to everything (jnp.argmin/min would pick NaN)."""
    return jnp.where(jnp.isnan(cost), jnp.inf, cost)


def _prefer_first(sol_a: Solution, sol_b: Solution) -> jnp.ndarray:
    """True lexicographic (converged, cost) preference for ``sol_a`` over
    ``sol_b``; ties go to ``sol_b``. No big-penalty arithmetic — a 1e30
    offset swamps the cost term entirely in f32, which would make the
    cost tiebreak a no-op whenever both candidates share a converged flag."""
    c_a = _sanitize_cost(sol_a.cost)
    c_b = _sanitize_cost(sol_b.cost)
    return jnp.where(
        sol_a.converged == sol_b.converged, c_a < c_b, sol_a.converged
    )


def _select_best(sols: Solution) -> jnp.ndarray:
    """Index of the lexicographically best candidate in a batched Solution:
    lowest (NaN-safe) cost among the converged, else lowest cost overall."""
    cost = _sanitize_cost(sols.cost)
    masked = jnp.where(sols.converged, cost, jnp.inf)
    return jnp.where(jnp.any(sols.converged), jnp.argmin(masked), jnp.argmin(cost))


def make_multistart_solver(
    ocp: OCP,
    ilqr_settings: SolverSettings = SolverSettings(),
    mppi_settings: MppiSettings | None = None,
    swing_fracs: tuple = (1.0, 0.5),
    include_mppi: bool = True,
):
    """Multi-start global/local solve: one batched iLQR polish over
    {the caller's warm start, the MPPI elite, deterministic arc seeds},
    best-of by (converged, cost). ``solve(theta, U0, key) -> Solution``.

    Rationale: sampling alone cannot bridge every nonconvexity — on a
    symmetric saddle (an obstacle dead-center on the start-goal line) the
    cost gradient cannot break the tie and MPPI's exploration variance is
    far smaller than the goal distance, so both the plain iLQR and the
    MPPI-seeded hybrid hover behind the obstacle. Deterministic bang-bang
    arc seeds (drive channel at 0.75 of its upper bound, swing channel
    +/- for the first quarter of the horizon, reversed for the second)
    break the symmetry structurally; the Newton polish does the rest
    (tools/demo_escape.py: 28% lower cost on the saddle scenario, goal
    reached vs hovered). Seeds are built from the control box alone, so the
    construction applies to any 2+-control platform (unicycle (v, w),
    bicycle (v, delta), smooth unicycle (a, alpha)).

    All starts polish under one ``vmap``-batched iLQR call — the
    K+2 starts ride the batch axis a scenario bank would, so wall-clock is
    roughly ONE solve, not K+2.
    """
    ilqr = make_solver(ocp, ilqr_settings)
    mppi = (
        make_mppi_solver(ocp, mppi_settings or MppiSettings(n_samples=128, n_iters=8))
        if include_mppi
        else None
    )
    N, m = ocp.horizon, ocp.n_controls
    if m < 2:
        raise ValueError("arc seeds need a drive and a swing channel (n_controls >= 2)")
    u_lo = jnp.asarray(ocp.u_lo)
    u_hi = jnp.asarray(ocp.u_hi)
    seeds = []
    fwd = 0.75 * u_hi[0]
    q = max(1, N // 4)
    for frac in swing_fracs:
        for sgn in (1.0, -1.0):
            U = jnp.zeros((N, m)).at[:, 0].set(fwd)
            U = U.at[:q, -1].set(sgn * frac * u_hi[-1])
            U = U.at[q : 2 * q, -1].set(sgn * frac * u_lo[-1])
            seeds.append(jnp.clip(U, u_lo, u_hi))
    ARC_SEEDS = jnp.stack(seeds)  # (K, N, m)

    def solve(theta, U0, key):
        starts = [jnp.clip(jnp.asarray(U0, jnp.result_type(float)), u_lo, u_hi)]
        n_extra = jnp.zeros((), jnp.int32)
        if mppi is not None:
            sol_m = mppi(theta, starts[0], key)
            starts.append(sol_m.U)
            n_extra = sol_m.n_iters
        cands = jnp.concatenate([jnp.stack(starts), ARC_SEEDS], axis=0)
        sols = jax.vmap(ilqr, in_axes=(None, 0))(theta, cands)
        i = _select_best(sols)
        return Solution(
            U=sols.U[i],
            X=sols.X[i],
            cost=sols.cost[i],
            kkt_residual=sols.kkt_residual[i],
            converged=sols.converged[i],
            n_iters=jnp.asarray(ilqr_settings.total_iters, jnp.int32) + n_extra,
            reg=sols.reg[i],
        )

    return solve


def make_hybrid_solver(
    ocp: OCP,
    ilqr_settings: SolverSettings = SolverSettings(),
    mppi_settings: MppiSettings | None = None,
):
    """Global-then-local: MPPI exploration seeds the interior-point iLQR.

    ``solve(theta, U0, key) -> Solution``. MPPI runs a short exploration
    schedule from ``U0``, then the iLQR polishes its best sequence to KKT
    tolerance; the polished solution is kept only if it actually beats the
    plain iLQR-from-``U0`` answer on (converged, cost) — so the hybrid is
    never worse than the local engine it wraps.

    This targets the measured failure mode of the local engine: on
    obstacle-cluttered point-stabilization banks a few percent of cold-started
    solves stall on the wrong side of an exponential obstacle wall
    (bench.py corrected-mode converged fraction). Sampling crosses the wall;
    Newton then closes the KKT residual.
    """
    if mppi_settings is None:
        # short exploration schedule: the polish does the fine work
        mppi_settings = MppiSettings(n_samples=128, n_iters=8)
    mppi = make_mppi_solver(ocp, mppi_settings)
    ilqr = make_solver(ocp, ilqr_settings)

    def solve(theta, U0, key):
        sol_m = mppi(theta, U0, key)
        sol_a = ilqr(theta, sol_m.U)  # polish the explored basin
        sol_b = ilqr(theta, U0)  # the plain local solve
        # prefer converged; among equals prefer lower cost; ties -> plain
        take_a = _prefer_first(sol_a, sol_b)
        pick = lambda a, b: jnp.where(take_a, a, b)
        return Solution(
            U=pick(sol_a.U, sol_b.U),
            X=pick(sol_a.X, sol_b.X),
            cost=pick(sol_a.cost, sol_b.cost),
            kkt_residual=pick(sol_a.kkt_residual, sol_b.kkt_residual),
            converged=jnp.where(take_a, sol_a.converged, sol_b.converged),
            n_iters=sol_a.n_iters + sol_b.n_iters,
            reg=pick(sol_a.reg, sol_b.reg),
        )

    return solve
