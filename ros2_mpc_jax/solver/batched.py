"""Lane-aligned bank solver: the model-generic XLA bank engine.

``jax.vmap(solve)`` (solver/ilqr.py) is the correctness reference, but it
lays every intermediate out batch-major — e.g. a Riccati carry of shape
(4096, 3, 3), whose tiny minor 3x3 dims make every op of every scan step a
strided, padded access.

This engine keeps the scenario batch as the two *minor* dims, shaped
``batch_shape = (B // 128, 128)`` — contiguous, unit-stride scenario
vectors — and unrolls the tiny n x n / m x m linear algebra into explicit
component arithmetic on (..., B1, B2) arrays, which XLA fuses into
full-width elementwise loops:

* states/controls: (n, B1, B2); per-stage stacks lead with N;
* Jacobians A (n, n, B1, B2), B (n, m, B1, B2) built from ``jax.jvp``
  basis columns (elementwise primitives preserve the trailing batch dims);
* stage-cost gradients via ``jax.grad`` of the batch-summed cost (exact,
  since scenarios are separable), Hessians via n+m forward-over-reverse
  jvps;
* the Riccati backward/forward sweeps, Armijo line search, acceptance and
  Levenberg regularization are all per-scenario (masks shaped (B1, B2)).

The engine is **model-generic over small OCPs**: any
:class:`~ros2_mpc_jax.solver.ilqr.OCP` whose ``transition``/``stage_cost``
are written with trailing-component batched semantics (``x[..., i]`` +
``stack(axis=-1)`` — every model in ``models/``) and whose (n, m) are small
enough to unroll (n <= 16, m <= 8 is the sane envelope) runs at bank
throughput. The m x m ``Quu`` solve dispatches on m: the 2-control
platforms (unicycle, bicycle, smooth) take the closed-form 2x2 inverse;
anything larger (the 4-control quadrotor) takes the unrolled component
Cholesky :func:`_chol_solve` with the same PD safeguard. The reference's
solver layer was model-generic too (one ``get_system_function`` plugged
into CasADi, ros2_mpc/planner/local_planner_tracking.py:161-178) — this is
the bank-scale equivalent.

Same algorithm and schedule as :mod:`~ros2_mpc_jax.solver.ilqr` (log-barrier
continuation interior-point iLQR) — tests assert the two engines agree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ilqr import OCP, Solution, SolverSettings


# --- tiny component-unrolled linear algebra on (m, n, *batch) stacks ---


def _matmul(A, B):
    """(m, k, *bs) @ (k, n, *bs) -> (m, n, *bs), fully unrolled."""
    m, k = A.shape[0], A.shape[1]
    n = B.shape[1]
    rows = []
    for i in range(m):
        cols = []
        for j in range(n):
            acc = A[i, 0] * B[0, j]
            for l in range(1, k):
                acc = acc + A[i, l] * B[l, j]
            cols.append(acc)
        rows.append(jnp.stack(cols))
    return jnp.stack(rows)


def _matvec(A, v):
    """(m, k, *bs) @ (k, *bs) -> (m, *bs)."""
    m, k = A.shape[0], A.shape[1]
    out = []
    for i in range(m):
        acc = A[i, 0] * v[0]
        for l in range(1, k):
            acc = acc + A[i, l] * v[l]
        out.append(acc)
    return jnp.stack(out)


def _transpose(A):
    return jnp.swapaxes(A, 0, 1)


def _sym(A):
    return 0.5 * (A + _transpose(A))


def _solve2x2(M, rhs_cols):
    """Solve M X = rhs for 2x2 SPD-safeguarded M; rhs (2, n, *bs)."""
    a, b = M[0, 0], M[0, 1]
    c, d = M[1, 0], M[1, 1]
    det = a * d - b * c
    bad = jnp.logical_or(det <= 1e-12, jnp.minimum(a, d) <= 0.0)
    a = jnp.where(bad, a + 1e3, a)
    d = jnp.where(bad, d + 1e3, d)
    det = jnp.where(bad, a * d - b * c, det)
    inv_det = 1.0 / det
    r0, r1 = rhs_cols[0], rhs_cols[1]
    x0 = (d * r0 - b * r1) * inv_det
    x1 = (a * r1 - c * r0) * inv_det
    return jnp.stack([x0, x1]), (a, b, c, d)


def _chol_factor(M):
    """Unrolled Cholesky of (m, m, *bs) component stacks.

    Returns (L rows-of-lists, min_pivot) where L[i][k] (k <= i) are the
    factor components and ``min_pivot`` is the smallest diagonal pivot seen
    before the sqrt clamp — the PD certificate for the safeguard."""
    m = M.shape[0]
    L = [[None] * m for _ in range(m)]
    min_piv = None
    for i in range(m):
        s = M[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        min_piv = s if min_piv is None else jnp.minimum(min_piv, s)
        d = jnp.sqrt(jnp.maximum(s, 1e-20))
        L[i][i] = d
        inv_d = 1.0 / d
        for j in range(i + 1, m):
            t = M[j, i]
            for k in range(i):
                t = t - L[j][k] * L[i][k]
            L[j][i] = t * inv_d
    return L, min_piv


def _chol_solve(M, rhs_cols):
    """Solve M X = rhs for m x m SPD-safeguarded M via unrolled Cholesky.

    The generic-(n, m) twin of :func:`_solve2x2` (the m=2 closed form stays
    the fast path): ``M`` is (m, m, *bs) component-stacked, ``rhs_cols`` is
    (m, n_rhs, *bs). Lost positive-definiteness is detected by the
    factorization's own pivots and answered with the same heavy diagonal
    loading as the 2x2 path (the Levenberg outer loop then backs the step
    off). Everything is unrolled component arithmetic on (*bs,) arrays, so
    the whole solve fuses into full-width elementwise loops like the rest of the
    engine — no batched ``linalg`` calls, no (m, m) minor-dim tiles."""
    m = M.shape[0]
    _, min_piv = _chol_factor(M)
    bad = min_piv <= 1e-12
    load = jnp.where(bad, 1e3, 0.0)
    M = M + load * jnp.reshape(jnp.eye(m), (m, m) + (1,) * (M.ndim - 2))
    L, _ = _chol_factor(M)
    n_rhs = rhs_cols.shape[1]
    cols = []
    for j in range(n_rhs):
        # forward substitution: L y = rhs[:, j]
        y = [None] * m
        for i in range(m):
            t = rhs_cols[i, j]
            for k in range(i):
                t = t - L[i][k] * y[k]
            y[i] = t / L[i][i]
        # back substitution: L^T x = y
        x = [None] * m
        for i in reversed(range(m)):
            t = y[i]
            for k in range(i + 1, m):
                t = t - L[k][i] * x[k]
            x[i] = t / L[i][i]
        cols.append(jnp.stack(x))
    return jnp.stack(cols, axis=1)  # (m, n_rhs, *bs)


def _batch_last(leaf, B, bs):
    """(B, *s) -> (*s, B1, B2)."""
    moved = jnp.moveaxis(leaf, 0, -1)
    return moved.reshape(moved.shape[:-1] + bs)


def _batch_first(arr, B, bs):
    """(*s, B1, B2) -> (B, *s)."""
    flat = arr.reshape(arr.shape[:-2] + (B,))
    return jnp.moveaxis(flat, -1, 0)


def _make_adapters(ocp: OCP):
    """Lane-layout adapters for one OCP: ``step``/``stage_cost``/
    ``terminal_cost`` operating on (components..., B1, B2) stacks.

    ``F`` and the costs were written for (..., n) component-trailing
    vectors; components move last and back around each call. Model
    transitions are elementwise (trig + muls), so the trailing batch dims
    survive untouched; costs go through two nested trailing-axis vmaps."""
    F = ocp.transition

    def step(x, u):
        xt = jnp.moveaxis(x, 0, -1)
        ut = jnp.moveaxis(u, 0, -1)
        return jnp.moveaxis(F(xt, ut), -1, 0)

    def stage_cost(x, u, k, theta):
        xt = jnp.moveaxis(x, 0, -1)
        ut = jnp.moveaxis(u, 0, -1)

        def one(xv, uv, th):
            return ocp.stage_cost(xv, uv, k, th)

        f2 = jax.vmap(one, in_axes=(-2, -2, -1), out_axes=-1)
        f3 = jax.vmap(f2, in_axes=(-2, -2, -1), out_axes=-1)
        return f3(xt, ut, theta)

    def terminal_cost(x, theta):
        xt = jnp.moveaxis(x, 0, -1)

        def one(xv, th):
            return ocp.terminal_cost(xv, th)

        f2 = jax.vmap(one, in_axes=(-2, -1), out_axes=-1)
        f3 = jax.vmap(f2, in_axes=(-2, -1), out_axes=-1)
        out = f3(xt, theta)
        return out if out.ndim else jnp.zeros(x.shape[-2:])

    return step, stage_cost, terminal_cost


def _probe_batch_semantics(F, n, m):
    """Build-time guard: the engine's ``step`` adapter hands ``F`` arrays
    with trailing batch dims and trusts broadcasting. A transition written
    with scalar-only semantics (e.g. ``x[2]`` instead of ``x[..., 2]``)
    would produce silently wrong banks — catch it here with one concrete
    2x2 probe against the vmapped truth."""
    bs = (2, 2)
    xt = jnp.moveaxis(jnp.linspace(-0.3, 0.3, n * 4).reshape((n,) + bs), 0, -1)
    ut = jnp.moveaxis(jnp.linspace(-0.1, 0.1, m * 4).reshape((m,) + bs), 0, -1)
    try:
        batched = F(xt, ut)
    except Exception as e:  # pragma: no cover - shape errors vary by model
        raise ValueError(
            "lane-aligned engine needs a transition with (..., n) batched "
            f"semantics (models/ style); F raised on a batched probe: {e}"
        ) from e
    looped = jax.vmap(jax.vmap(F))(xt, ut)
    if batched.shape != looped.shape or not bool(
        jnp.allclose(batched, looped, atol=1e-5)
    ):
        raise ValueError(
            "lane-aligned engine needs a transition with (..., n) batched "
            "semantics: F(x_batch, u_batch) disagrees with vmap(F) on a probe"
        )


def make_bank_solver_fast(ocp: OCP, settings: SolverSettings = SolverSettings(), lanes: int = 128):
    """Build ``solve_bank(thetas, U0s) -> Solution`` over a B-leading bank.

    ``B`` must be a multiple of ``lanes`` (pad the bank if not). The returned
    function is jit-compatible; under pjit the minor batch dims shard like
    any other. Model-generic: any small-(n, m) OCP with batch-safe
    ``transition``/costs (see the module docstring); a build-time probe
    rejects transitions with scalar-only semantics.
    """
    N, n, m = ocp.horizon, ocp.n_states, ocp.n_controls
    _probe_batch_semantics(ocp.transition, n, m)
    F = ocp.transition
    u_lo1 = jnp.asarray(ocp.u_lo)
    u_hi1 = jnp.asarray(ocp.u_hi)
    ks = jnp.arange(N)
    alphas = 0.5 ** jnp.arange(settings.n_alphas)
    n_alphas = settings.n_alphas

    def bshape(x0):
        return x0.shape[-2:]

    def expand(v, bs):
        """(m,) constant -> (m, 1, 1) broadcastable over the batch."""
        return v.reshape((v.shape[0],) + (1,) * len(bs))

    # --- batched primitives (trailing batch preserved: all elementwise) ---

    step, stage_cost, terminal_cost = _make_adapters(ocp)

    def barrier(u, mu):
        lo = expand(u_lo1, u.shape[1:])
        hi = expand(u_hi1, u.shape[1:])
        return -mu * jnp.sum(jnp.log(u - lo) + jnp.log(hi - u), axis=0)

    def stage_cost_mu(x, u, k, theta, mu):
        return stage_cost(x, u, k, theta) + barrier(u, mu)

    def rollout(x0, U, theta, mu):
        """U: (N, m, *bs) -> X (N+1, n, *bs), scalar-per-scenario cost."""

        def body(carry, inp):
            x, acc = carry
            u, k = inp
            acc = acc + stage_cost_mu(x, u, k, theta, mu)
            xn = step(x, u)
            return (xn, acc), xn

        (xN, acc), X_tail = jax.lax.scan(body, (x0, jnp.zeros(x0.shape[-2:])), (U, ks))
        X = jnp.concatenate([x0[None], X_tail], axis=0)
        return X, acc + terminal_cost(xN, theta)

    def true_cost(U, theta):
        x0 = theta["x0"]

        def body(carry, inp):
            x, acc = carry
            u, k = inp
            acc = acc + stage_cost(x, u, k, theta)
            return (step(x, u), acc), None

        (xN, acc), _ = jax.lax.scan(body, (x0, jnp.zeros(x0.shape[-2:])), (U, ks))
        return acc + terminal_cost(xN, theta)

    def stage_derivs(X, U, theta, mu):
        """All-stage derivatives, batched over the leading N axis."""
        bs = X.shape[-2:]

        def one_stage(x, u, k):
            # dynamics Jacobian columns: ONE linearization shared across all
            # n+m basis tangents (jax.linearize evaluates the primal once;
            # per-column jvp would re-trace the primal RK4 per column — at
            # n=12 that's 12 redundant rollout stages XLA may not CSE)
            eye_n = jnp.eye(n)
            eye_m = jnp.eye(m)
            _, step_lin = jax.linearize(step, x, u)
            zx = jnp.zeros_like(x)
            zu = jnp.zeros_like(u)
            A_cols = [
                step_lin(jnp.broadcast_to(expand(eye_n[i], bs), x.shape), zu)
                for i in range(n)
            ]
            B_cols = [
                step_lin(zx, jnp.broadcast_to(expand(eye_m[i], bs), u.shape))
                for i in range(m)
            ]
            A = jnp.stack(A_cols, axis=1)  # (n, n, *bs)
            Bm = jnp.stack(B_cols, axis=1)  # (n, m, *bs)

            def gradfn(xx, uu):
                return jax.grad(
                    lambda xv, uv: jnp.sum(stage_cost_mu(xv, uv, k, theta, mu)), argnums=(0, 1)
                )(xx, uu)

            # Hessian rows: one forward-over-reverse linearization, n+m
            # cheap tangent applications (shared reverse pass)
            (lx, lu), grad_lin = jax.linearize(gradfn, x, u)
            Hx_rows = []
            for i in range(n):
                tx = jnp.broadcast_to(expand(eye_n[i], bs), x.shape)
                hxx, hxu = grad_lin(tx, zu)
                Hx_rows.append((hxx, hxu))
            Hu_rows = []
            for i in range(m):
                tu = jnp.broadcast_to(expand(eye_m[i], bs), u.shape)
                hux, huu = grad_lin(zx, tu)
                Hu_rows.append((hux, huu))
            lxx = jnp.stack([r[0] for r in Hx_rows], axis=0)  # (n, n, *bs)
            lux = jnp.stack([r[0] for r in Hu_rows], axis=0)  # (m, n, *bs)
            luu = jnp.stack([r[1] for r in Hu_rows], axis=0)  # (m, m, *bs)
            return A, Bm, lx, lu, _sym(lxx), lux, _sym(luu)

        return jax.vmap(one_stage, in_axes=(0, 0, 0))(X[:-1], U, ks)

    def backward(X, U, theta, mu, reg):
        bs = X.shape[-2:]
        A, Bm, lx, lu, lxx, lux, luu = stage_derivs(X, U, theta, mu)

        xN = X[-1]
        tgrad = jax.grad(lambda xv: jnp.sum(terminal_cost(xv, theta)))
        gN, tgrad_lin = jax.linearize(tgrad, xN)
        eye_n = jnp.eye(n)
        VxxN_rows = [
            tgrad_lin(jnp.broadcast_to(expand(eye_n[i], bs), xN.shape))
            for i in range(n)
        ]
        VxxN = _sym(jnp.stack(VxxN_rows, axis=0))

        def body(carry, inp):
            Vx, Vxx, dV1, dV2 = carry
            A_k, B_k, lx_k, lu_k, lxx_k, lux_k, luu_k = inp
            At = _transpose(A_k)
            Bt = _transpose(B_k)
            Qx = lx_k + _matvec(At, Vx)
            Qu = lu_k + _matvec(Bt, Vx)
            VxxA = _matmul(Vxx, A_k)
            Qxx = lxx_k + _matmul(At, VxxA)
            Qux = lux_k + _matmul(Bt, VxxA)
            Quu = luu_k + _matmul(Bt, _matmul(Vxx, B_k))
            for i in range(m):
                Quu = Quu.at[i, i].add(reg)
            Quu = _sym(Quu)
            rhs = jnp.concatenate([Qu[:, None], Qux], axis=1)  # (m, 1+n, *bs)
            if m == 2:
                sol, _ = _solve2x2(Quu, rhs)
            else:
                sol = _chol_solve(Quu, rhs)
            kff = -sol[:, 0]
            K = -sol[:, 1:]
            Kt = _transpose(K)
            Quu_k = _matvec(Quu, kff)
            Vx_n = Qx + _matvec(Kt, Quu_k) + _matvec(Kt, Qu) + _matvec(_transpose(Qux), kff)
            Vxx_n = _sym(
                Qxx + _matmul(Kt, _matmul(Quu, K)) + _matmul(Kt, Qux) + _matmul(_transpose(Qux), K)
            )
            dV1 = dV1 + jnp.sum(kff * Qu, axis=0)
            dV2 = dV2 + 0.5 * jnp.sum(kff * Quu_k, axis=0)
            return (Vx_n, Vxx_n, dV1, dV2), (kff, K)

        zero = jnp.zeros(bs)
        (_, _, dV1, dV2), (kffs, Ks) = jax.lax.scan(
            body, (gN, VxxN, zero, zero), (A, Bm, lx, lu, lxx, lux, luu), reverse=True
        )
        return kffs, Ks, dV1, dV2

    def forward_candidates(U, X, kffs, Ks, theta, mu):
        """All line-search candidates in one sweep: leading K axis."""
        bs = X.shape[-2:]
        lo = expand(u_lo1, bs)
        hi = expand(u_hi1, bs)
        eps = settings.interior_clip * (hi - lo)
        x0 = jnp.broadcast_to(theta["x0"][None], (n_alphas,) + theta["x0"].shape)
        al = alphas.reshape((n_alphas,) + (1,) * (1 + len(bs)))

        def body(carry, inp):
            xs, acc = carry  # (K, n, *bs), (K, *bs)
            u_old, x_old, kff, K_fb, k = inp
            dx = xs - x_old[None]  # (K, n, *bs)
            fb = jnp.stack(
                [sum(K_fb[i, j] * dx[:, j] for j in range(n)) for i in range(m)], axis=1
            )  # (K, m, *bs)
            u = u_old[None] + al * kff[None] + fb
            u = jnp.clip(u, lo[None] + eps[None], hi[None] - eps[None])
            c = jax.vmap(lambda xx, uu: stage_cost_mu(xx, uu, k, theta, mu))(xs, u)
            xn = jax.vmap(step)(xs, u)
            return (xn, acc + c), u

        (xN, acc), U_cand = jax.lax.scan(
            body, (x0, jnp.zeros((n_alphas,) + bs)), (U, X[:-1], kffs, Ks, ks)
        )
        J_cand = acc + jax.vmap(lambda xx: terminal_cost(xx, theta))(xN)
        return U_cand, J_cand  # (N, K, m, *bs), (K, *bs)

    def solve_bank(thetas, U0s):
        """thetas: B-leading pytree; U0s: (B, N, m). Returns B-leading Solution."""
        B = jax.tree_util.tree_leaves(thetas)[0].shape[0]
        assert B % lanes == 0, f"bank size {B} must be a multiple of {lanes}"
        bs = (B // lanes, lanes)
        theta = jax.tree_util.tree_map(lambda l: _batch_last(l, B, bs), thetas)
        U = _batch_last(U0s, B, bs)  # (N, m, *bs)
        lo = expand(u_lo1, bs)
        hi = expand(u_hi1, bs)
        eps0 = 1e-3 * (hi - lo)
        U = jnp.clip(U.astype(jnp.result_type(float)), lo + eps0, hi - eps0)
        reg = jnp.full(bs, settings.reg_init)

        def iteration(carry, mu):
            U, reg = carry
            X, J = rollout(theta["x0"], U, theta, mu)
            kffs, Ks, dV1, dV2 = backward(X, U, theta, mu, reg)
            U_cand, J_cand = forward_candidates(U, X, kffs, Ks, theta, mu)
            exp_red = -(alphas.reshape((n_alphas,) + (1,) * len(bs)) * dV1[None]
                        + (alphas**2).reshape((n_alphas,) + (1,) * len(bs)) * dV2[None])
            J_cand = jnp.where(jnp.isnan(J_cand), jnp.inf, J_cand)
            accept = J_cand <= J[None] - settings.armijo_c1 * jnp.maximum(exp_red, 0.0)
            any_acc = jnp.any(accept, axis=0)  # (*bs)
            idx = jnp.argmax(accept, axis=0)  # (*bs) first (largest) accepted
            U_best = jnp.take_along_axis(U_cand, idx[None, None, None], axis=1)[:, 0]
            U_next = jnp.where(any_acc, U_best, U)
            reg_next = jnp.where(
                any_acc,
                jnp.maximum(reg * 0.5, settings.reg_min),
                jnp.minimum(reg * 10.0 + settings.reg_min, settings.reg_max),
            )
            return (U_next, reg_next), None

        (U, reg), _ = jax.lax.scan(iteration, (U, reg), settings.mu_schedule())

        X, _ = rollout(theta["x0"], U, theta, settings.mu_final)
        J = true_cost(U, theta)
        g = jax.grad(lambda UU: jnp.sum(true_cost(UU, theta)))(U)
        kkt = jnp.max(jnp.abs(U - jnp.clip(U - g, lo, hi)), axis=(0, 1))
        return Solution(
            U=_batch_first(U, B, bs),
            X=_batch_first(X, B, bs),
            cost=_batch_first(J, B, bs),
            kkt_residual=_batch_first(kkt, B, bs),
            converged=_batch_first(kkt < settings.kkt_tol, B, bs),
            # (B,)-broadcast to match jax.vmap(solve)'s output pytree exactly
            n_iters=jnp.full((B,), settings.total_iters, dtype=jnp.int32),
            reg=_batch_first(reg, B, bs),
        )

    return solve_bank


def make_bank_kkt_polish(
    ocp: OCP,
    *,
    n_iters: int = 12,
    n_alphas: int = 5,
    reg: float = 1e-7,
    bound_tol: float = 1e-5,
    kkt_tol: float = SolverSettings().kkt_tol,
    lanes: int = 128,
):
    """Last-mile KKT-descent polish: converge the rows f32 Armijo cannot.

    Measured failure mode of the interior-point engines on obstacle-cliff
    geometries (round-5 diagnosis, saddle bank): the surviving stragglers
    sit at KKT 1e-4..4e-4 with (a) a drive channel pinned at its bound,
    where the barrier's curvature ``mu/clip_eps^2 ~ 1e7`` poisons the
    Riccati direction for the *free* channel, and (b) total costs ~1e2,
    where the remaining per-step improvement (~1e-8) is far below f32 cost
    resolution (~1e-5) — so merit-based line search can never accept
    another step, in any engine, at any schedule. Two changes make the
    last mile measurable in f32:

    * **box-DDP active-set masking** (Tassa-style control-limited DDP):
      channels at a bound with outward gradient are identified and pinned
      — their rows/columns leave ``Quu``/``Qux``/``Qu`` — so the Newton
      direction is exact on the free subspace instead of being corrupted
      by clipped-channel coupling;
    * **acceptance on the projected-gradient norm** instead of the cost:
      near the optimum the KKT residual (~1e-4) is fully resolvable in
      f32 where cost differences are not; candidates are accepted only if
      they strictly reduce it, so the iteration is monotone in the
      convergence metric itself.

    Runs on the lane-aligned layout at bank throughput; intended as the
    compacted third stage after the multistart + rescue passes
    (solver/rescue.py::make_multistart_two_pass_solver), where it converts
    the f32-floor tail into strict converges (measured on the CPU saddle
    bank: 26 of 27 surviving stragglers to KKT < 1e-4, median 1.5e-6).

    Returns ``polish(thetas, U0s) -> Solution`` (B-leading; ``U0s`` is the
    warm start being polished). Per-row KKT is monotone non-increasing by
    construction.
    """
    N, n, m = ocp.horizon, ocp.n_states, ocp.n_controls
    _probe_batch_semantics(ocp.transition, n, m)
    step, stage_cost, terminal_cost = _make_adapters(ocp)
    u_lo1 = jnp.asarray(ocp.u_lo)
    u_hi1 = jnp.asarray(ocp.u_hi)
    ks = jnp.arange(N)
    alphas = 0.5 ** jnp.arange(n_alphas)

    def expand(v, bs):
        return v.reshape((v.shape[0],) + (1,) * len(bs))

    def true_cost(U, theta):
        def body(carry, inp):
            x, acc = carry
            u, k = inp
            acc = acc + stage_cost(x, u, k, theta)
            return (step(x, u), acc), None

        (xN, acc), _ = jax.lax.scan(
            body, (theta["x0"], jnp.zeros(theta["x0"].shape[-2:])), (U, ks)
        )
        return acc + terminal_cost(xN, theta)

    def roll_states(U, theta):
        def body(x, u):
            xn = step(x, u)
            return xn, xn

        _, X_tail = jax.lax.scan(body, theta["x0"], U)
        return jnp.concatenate([theta["x0"][None], X_tail], axis=0)

    def kkt_of(U, theta, lo, hi):
        g = jax.grad(lambda UU: jnp.sum(true_cost(UU, theta)))(U)
        return jnp.max(jnp.abs(U - jnp.clip(U - g, lo, hi)), axis=(0, 1))

    def stage_derivs(X, U, theta):
        """True-cost quadratization (no barrier), batched over stages."""
        bs = X.shape[-2:]

        def one_stage(x, u, k):
            eye_n = jnp.eye(n)
            eye_m = jnp.eye(m)
            _, step_lin = jax.linearize(step, x, u)
            zx = jnp.zeros_like(x)
            zu = jnp.zeros_like(u)
            A_cols = [
                step_lin(jnp.broadcast_to(expand(eye_n[i], bs), x.shape), zu)
                for i in range(n)
            ]
            B_cols = [
                step_lin(zx, jnp.broadcast_to(expand(eye_m[i], bs), u.shape))
                for i in range(m)
            ]
            A = jnp.stack(A_cols, axis=1)
            Bm = jnp.stack(B_cols, axis=1)

            def gradfn(xx, uu):
                return jax.grad(
                    lambda xv, uv: jnp.sum(stage_cost(xv, uv, k, theta)), argnums=(0, 1)
                )(xx, uu)

            (lx, lu), grad_lin = jax.linearize(gradfn, x, u)
            Hx_rows = []
            for i in range(n):
                tx = jnp.broadcast_to(expand(eye_n[i], bs), x.shape)
                hxx, hxu = grad_lin(tx, zu)
                Hx_rows.append((hxx, hxu))
            Hu_rows = []
            for i in range(m):
                tu = jnp.broadcast_to(expand(eye_m[i], bs), u.shape)
                hux, huu = grad_lin(zx, tu)
                Hu_rows.append((hux, huu))
            lxx = jnp.stack([r[0] for r in Hx_rows], axis=0)
            lux = jnp.stack([r[0] for r in Hu_rows], axis=0)
            luu = jnp.stack([r[1] for r in Hu_rows], axis=0)
            return A, Bm, lx, lu, _sym(lxx), lux, _sym(luu)

        return jax.vmap(one_stage, in_axes=(0, 0, 0))(X[:-1], U, ks)

    def backward_boxddp(X, U, theta, lo, hi):
        bs = X.shape[-2:]
        A, Bm, lx, lu, lxx, lux, luu = stage_derivs(X, U, theta)
        tgrad = jax.grad(lambda xv: jnp.sum(terminal_cost(xv, theta)))
        gN, tgrad_lin = jax.linearize(tgrad, X[-1])
        eye_n = jnp.eye(n)
        VxxN_rows = [
            tgrad_lin(jnp.broadcast_to(expand(eye_n[i], bs), X[-1].shape))
            for i in range(n)
        ]
        VxxN = _sym(jnp.stack(VxxN_rows, axis=0))
        tol_b = bound_tol * (hi - lo)

        def body(carry, inp):
            Vx, Vxx = carry
            A_k, B_k, lx_k, lu_k, lxx_k, lux_k, luu_k, u_k = inp
            At = _transpose(A_k)
            Bt = _transpose(B_k)
            Qx = lx_k + _matvec(At, Vx)
            Qu = lu_k + _matvec(Bt, Vx)
            VxxA = _matmul(Vxx, A_k)
            Qxx = lxx_k + _matmul(At, VxxA)
            Qux = lux_k + _matmul(Bt, VxxA)
            Quu = luu_k + _matmul(Bt, _matmul(Vxx, B_k))
            for i in range(m):
                Quu = Quu.at[i, i].add(reg)
            Quu = _sym(Quu)
            # box-DDP identification: a channel at its bound whose gradient
            # pushes outward is pinned — zero its rows/cols, unit diagonal
            act = jnp.logical_or(
                jnp.logical_and(u_k <= lo + tol_b, Qu > 0),
                jnp.logical_and(u_k >= hi - tol_b, Qu < 0),
            )
            free = 1.0 - act.astype(Qu.dtype)
            Qu = Qu * free
            Qux = Qux * free[:, None]
            Quu = Quu * (free[:, None] * free[None, :])
            for i in range(m):
                Quu = Quu.at[i, i].add(1.0 - free[i])
            rhs = jnp.concatenate([Qu[:, None], Qux], axis=1)
            if m == 2:
                sol, _ = _solve2x2(Quu, rhs)
            else:
                sol = _chol_solve(Quu, rhs)
            kff = -sol[:, 0]
            K = -sol[:, 1:]
            Kt = _transpose(K)
            Quu_k = _matvec(Quu, kff)
            Vx_n = Qx + _matvec(Kt, Quu_k) + _matvec(Kt, Qu) + _matvec(_transpose(Qux), kff)
            Vxx_n = _sym(
                Qxx + _matmul(Kt, _matmul(Quu, K)) + _matmul(Kt, Qux) + _matmul(_transpose(Qux), K)
            )
            return (Vx_n, Vxx_n), (kff, K)

        (_, _), (kffs, Ks) = jax.lax.scan(
            body, (gN, VxxN), (A, Bm, lx, lu, lxx, lux, luu, U), reverse=True
        )
        return kffs, Ks

    def forward_candidates(U, X, kffs, Ks, theta, lo, hi):
        """Candidate controls for every alpha (no cost accumulation — the
        selection metric is the KKT residual, evaluated afterwards)."""
        eps = 1e-7 * (hi - lo)
        x0 = jnp.broadcast_to(theta["x0"][None], (n_alphas,) + theta["x0"].shape)
        al = alphas.reshape((n_alphas,) + (1,) * (1 + len(X.shape[-2:])))

        def body(xs, inp):
            u_old, x_old, kff, K_fb = inp
            dx = xs - x_old[None]
            fb = jnp.stack(
                [sum(K_fb[i, j] * dx[:, j] for j in range(n)) for i in range(m)], axis=1
            )
            u = u_old[None] + al * kff[None] + fb
            u = jnp.clip(u, lo[None] + eps[None], hi[None] - eps[None])
            xn = jax.vmap(step)(xs, u)
            return xn, u

        _, U_cand = jax.lax.scan(body, x0, (U, X[:-1], kffs, Ks))
        return U_cand  # (N, K, m, *bs)

    def polish_bank(thetas, U0s):
        B = jax.tree_util.tree_leaves(thetas)[0].shape[0]
        assert B % lanes == 0, f"bank size {B} must be a multiple of {lanes}"
        bs = (B // lanes, lanes)
        theta = jax.tree_util.tree_map(lambda l: _batch_last(l, B, bs), thetas)
        U = _batch_last(U0s, B, bs)
        lo = expand(u_lo1, bs)
        hi = expand(u_hi1, bs)
        eps0 = 1e-7 * (hi - lo)
        U = jnp.clip(U.astype(jnp.result_type(float)), lo + eps0, hi - eps0)
        k0 = kkt_of(U, theta, lo, hi)

        def iteration(carry, _):
            U_best, k_best = carry
            X = roll_states(U_best, theta)
            kffs, Ks = backward_boxddp(X, U_best, theta, lo, hi)
            U_cand = forward_candidates(U_best, X, kffs, Ks, theta, lo, hi)
            k_cand = jax.vmap(lambda Uc: kkt_of(Uc, theta, lo, hi), in_axes=1)(U_cand)
            i = jnp.argmin(k_cand, axis=0)  # (*bs)
            k_new = jnp.min(k_cand, axis=0)
            U_new = jnp.take_along_axis(U_cand, i[None, None, None], axis=1)[:, 0]
            better = k_new < k_best
            return (
                jnp.where(better, U_new, U_best),
                jnp.where(better, k_new, k_best),
            ), None

        (U, kkt), _ = jax.lax.scan(iteration, (U, k0), None, length=n_iters)
        X = roll_states(U, theta)
        J = true_cost(U, theta)
        return Solution(
            U=_batch_first(U, B, bs),
            X=_batch_first(X, B, bs),
            cost=_batch_first(J, B, bs),
            kkt_residual=_batch_first(kkt, B, bs),
            converged=_batch_first(kkt < kkt_tol, B, bs),
            n_iters=jnp.full((B,), n_iters, dtype=jnp.int32),
            reg=jnp.full((B,), reg),
        )

    return polish_bank
