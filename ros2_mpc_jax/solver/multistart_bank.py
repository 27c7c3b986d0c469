"""Bank-scale multistart: basin escape at full engine throughput.

The per-scenario multistart/hybrid engines run their polish through
``jax.vmap(make_solver(...))`` one scenario at a time, orders of magnitude
below the bank engines, so basin escape could not run at bank scale. But a multistart IS a bank: K starts per
scenario over B scenarios is one (B*K)-scenario bank of the same OCP. This
module reshapes the seeds into the batch and routes the whole polish through
the lane-aligned or whole-solver-Pallas engines, then reduces best-of per
scenario by (converged, cost) — the same selection as
:func:`~ros2_mpc_jax.solver.mppi.make_multistart_solver`.

Seeds are the deterministic bang-bang arc seeds (drive channel at 0.75 of
its upper bound, swing channel +/- for the first quarter of the horizon,
reversed for the second) plus the caller's warm start: on a symmetric saddle
(an obstacle wall dead-center on the start-goal line) the cost gradient
cannot break the left/right tie, so every gradient method from a zero start
stalls against the wall; the arc seeds break the symmetry structurally.
MPPI exploration is intentionally absent here — the arc seeds are what
actually cracks saddles (see tools/demo_escape.py), and sampling would cost
the bank engines their throughput.

On the adversarial saddle bank (B=4096, N=40 — the canonical
symmetric-saddle geometry of tools/demo_escape.py at bank scale) the bank
multistart lifts the strict converged fraction well above the plain
single-start bank (bench.py's saddle_* secondaries) — basin escape as a
production mode, not a demo. The fast schedule is NOT a good pairing here:
the obstacle cliffs need the full barrier continuation.

The reference's only recovery from a failed solve is a node crash
(ros2_mpc/planner/local_planner_tracking.py:74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ilqr import OCP, Solution, SolverSettings


def arc_seeds(ocp: OCP, swing_fracs: tuple = (1.0, 0.5)) -> jnp.ndarray:
    """(K_arc, N, m) deterministic bang-bang symmetry-breaking seeds (the
    same construction as mppi.make_multistart_solver; box-only, so any
    2+-control platform works)."""
    N, m = ocp.horizon, ocp.n_controls
    if m < 2:
        raise ValueError("arc seeds need a drive and a swing channel (n_controls >= 2)")
    u_lo = jnp.asarray(ocp.u_lo)
    u_hi = jnp.asarray(ocp.u_hi)
    fwd = 0.75 * u_hi[0]
    q = max(1, N // 4)
    seeds = []
    for frac in swing_fracs:
        for sgn in (1.0, -1.0):
            U = jnp.zeros((N, m)).at[:, 0].set(fwd)
            U = U.at[:q, -1].set(sgn * frac * u_hi[-1])
            U = U.at[q : 2 * q, -1].set(sgn * frac * u_lo[-1])
            seeds.append(jnp.clip(U, u_lo, u_hi))
    return jnp.stack(seeds)


def make_bank_multistart_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    swing_fracs: tuple = (1.0, 0.5),
    engine: str = "pallas",
    **engine_opts,
):
    """Build ``solve(thetas, U0s) -> Solution`` (B-leading) that polishes
    K = 1 + 2*len(swing_fracs) starts per scenario through one bank-engine
    call and keeps the per-scenario best by (converged, cost).

    ``engine``: 'pallas' (whole-solver kernel; B*K must be a multiple of its
    ``tile_s * tile_l``) | 'fast' (lane-aligned) | 'vmap'. Throughput is the
    engine rate divided by K."""
    ARC = arc_seeds(ocp, swing_fracs)
    K = 1 + ARC.shape[0]

    if engine == "pallas":
        from .pallas_kernel import make_pallas_point_stab_solver

        bank_solve = make_pallas_point_stab_solver(ocp, settings, **engine_opts)
    elif engine == "fast":
        from .batched import make_bank_solver_fast

        bank_solve = make_bank_solver_fast(ocp, settings, **engine_opts)
    elif engine == "vmap":
        from .ilqr import make_solver

        if engine_opts:
            raise ValueError(f"engine='vmap' takes no engine_opts, got {sorted(engine_opts)}")
        bank_solve = jax.vmap(make_solver(ocp, settings))
    else:
        raise ValueError(f"unknown engine {engine!r}; expected 'pallas' | 'fast' | 'vmap'")

    def solve(thetas, U0s):
        B = U0s.shape[0]
        # scenario-major tiling: each scenario's K starts are adjacent rows,
        # so the (B, K) reshape below is a pure relabeling
        big_thetas = jax.tree_util.tree_map(
            lambda l: jnp.repeat(l, K, axis=0), thetas
        )
        starts = jnp.concatenate(
            [U0s[:, None], jnp.broadcast_to(ARC[None], (B,) + ARC.shape)], axis=1
        )  # (B, K, N, m)
        sols = bank_solve(big_thetas, starts.reshape(B * K, *U0s.shape[1:]))

        cost = jnp.where(jnp.isnan(sols.cost), jnp.inf, sols.cost).reshape(B, K)
        conv = sols.converged.reshape(B, K)
        masked = jnp.where(conv, cost, jnp.inf)
        i = jnp.where(
            jnp.any(conv, axis=1), jnp.argmin(masked, axis=1), jnp.argmin(cost, axis=1)
        )
        flat = jnp.arange(B) * K + i

        def take(leaf):
            return leaf[flat]

        return Solution(
            U=take(sols.U),
            X=take(sols.X),
            cost=take(sols.cost),
            kkt_residual=take(sols.kkt_residual),
            converged=take(sols.converged),
            n_iters=sols.n_iters if jnp.ndim(sols.n_iters) == 0 else take(sols.n_iters),
            reg=take(sols.reg),
        )

    return solve


def adversarial_saddle_bank(prob, B: int, seed: int = 0, q_boost=(5.0, 5.0, 0.05)):
    """A saddle-heavy (start, goal, obstacle) bank where single-start
    gradient solves demonstrably fail: each scenario puts one obstacle
    dead-center on its start-goal line — the symmetric-saddle geometry of
    tools/demo_escape.py at bank scale. The gradient cannot break the
    left/right tie, so the cold-started iLQR rolls up to the obstacle cliff
    and stalls (measured 24% strict-KKT failures at N=40 horizon).

    Build ``prob`` at a horizon long enough to actually reach the ~1 m goal
    (N=40 at the reference dt; at N=20 the goal is outside the reachable
    set and the saddle never binds). ``q_boost`` replaces the theta Q so
    reaching pays (the demo's weights); pass None to keep the problem's
    own. Returns (thetas, U0)."""
    rng = np.random.default_rng(seed)
    n_obs = prob.make_theta(np.zeros(3), np.zeros(3))["obs_x"].shape[0]
    x0 = np.concatenate(
        [rng.uniform(-0.05, 0.05, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    ang = rng.uniform(-np.pi, np.pi, size=B)
    dist = rng.uniform(0.9, 1.1, size=B)
    goal = np.stack(
        [
            x0[:, 0] + dist * np.cos(ang),
            x0[:, 1] + dist * np.sin(ang),
            rng.uniform(-np.pi, np.pi, size=B),
        ],
        axis=1,
    )
    mid = x0[:, :2] + 0.5 * dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    obs_x = np.full((B, n_obs), 100.0)
    obs_y = np.full((B, n_obs), 100.0)
    obs_x[:, 0] = mid[:, 0]
    obs_y[:, 0] = mid[:, 1]
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(goal), jnp.asarray(obs_x), jnp.asarray(obs_y)
    )
    if q_boost is not None:
        thetas = dict(thetas)
        thetas["Q"] = jnp.tile(jnp.asarray(q_boost), (B, 1))
    U0 = jnp.zeros((B, prob.ocp.horizon, prob.ocp.n_controls))
    return thetas, U0
