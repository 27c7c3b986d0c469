"""Whole-solver Pallas kernels: the reference unicycle NMPC problems, one
launch per scenario bank.

The XLA engines (solver/ilqr.py, solver/batched.py) express each solver
iteration as chains of scans over the horizon plus the line-search rollouts;
on a GPU every scan step is at least one small kernel launch. These kernels
run the complete interior-point iLQR — rollouts, analytic derivatives,
Riccati backward sweep, Armijo line search, barrier continuation — inside
ONE ``pallas_call``, compiled for the GPU through Pallas's Triton backend.
Two problems are covered (BASELINE.json configs 1/4 and the reference's
path follower): point stabilization (:func:`make_pallas_point_stab_solver`)
and trajectory tracking (:func:`make_pallas_tracking_solver`). Both share
one kernel body; they differ only in transition, references and terminal
cost.

Everything is hand-derived for the unicycle:

* **RK4 Jacobian, closed form** (point stabilization). For
  ``f = (v cos th, v sin th, w)`` the RK4 stages collapse (θ-dependence
  only): ``k3 == k2``, so ``F = x + dt/6 (k1 + 4 k2 + k4)`` with stage angles
  ``th1 = th, th2 = th + dt w / 2, th4 = th + dt w``. A and B are exact trig
  expressions — no autodiff in the kernel. Tracking uses the reference's
  Euler step (quirk #3), whose B has the structural zeros ``b01 = b11 = 0``.
* **Cost quadratization, closed form**: quadratic reference terms, reverse
  penalty ``exp(-rf v)``, the Gaussian obstacle sum (value/gradient/Hessian)
  and the log-barrier bound terms
  (local_planner_point_stabilization.py:60-67,104-127 formulations).
* The cost is separable in (x, u), so ``l_ux == 0`` and the Riccati update
  simplifies accordingly.

Layout: one scenario per thread. A bank is laid out scenario-minor — every
per-scenario quantity is an ``(..., B)`` plane viewed as
``(..., B // tile_l, tile_l)`` — and one program owns a ``(tile_s, tile_l)``
block of scenarios with ``tile_s`` warps, one warp per row of ``tile_l``
scenarios. Every load and store is of that one power-of-two block shape (the
Triton backend's requirement) and so of one register layout: each thread
reads back exactly the values it wrote. Compiled, ``tile_l`` is a multiple of
32 so that no scenario is replicated across threads.

Memory plan: the Triton backend has no scratch memory. The iterate (X, U)
lives in the kernel's own outputs; the Riccati gains and the line search's
best candidate live in a workspace output the wrapper discards. A program
touches only its own block (~1.2 KB per scenario at N=20, ~5 MB for a
4096-scenario bank, inside the GPU's L2). The schedule state — barrier stage
done, executed-work counters, regularizer, line-search accept mask — are
loop carries.

Accuracy contract: matches the XLA engines' solutions (tests/test_pallas.py)
and therefore the IPOPT-class oracle within the BASELINE tolerance.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .ilqr import OCP, Solution, SolverSettings

TILE_S = 1  # warps per program: rows of TILE_L scenarios
TILE_L = 32  # scenarios per row (one per thread of a warp)
OBS_CHUNK = 8  # obstacle points per unrolled step of the live-prefix loop
FAR = 100.0  # far-sentinel obstacle coordinate (the node layer's padding)

# Fast paired sin/cos: one shared 2*pi range reduction + odd/even minimax
# polynomials on [-pi, pi] (degree 13/14, least-squares fit; max abs error
# 3.3e-6 in f32 for |x| <= 60 rad, measured incl. reduction rounding). The
# kernels only ever need sin AND cos of the same angle, and control problems
# keep |theta| small (tens of radians across a long un-wrapped fleet
# rollout). The error is far inside the engines' mutual 1e-4 parity band and
# the BASELINE 1e-3 oracle bound. On an H100 (700 W) it runs the
# point-stabilization kernel 1.5x faster than jnp.cos/jnp.sin (PERF.md).
_FAST_SIN_COEFFS = (  # sin(pi*t) = t * P(t^2), t in [-1, 1]
    3.1415926409395274,
    -5.167712276801008,
    2.5501582806119174,
    -0.5992355764432307,
    0.08207129109395697,
    -0.007267320535221715,
    0.00039296507715625833,
)
_FAST_COS_COEFFS = (  # cos(pi*t) = Q(t^2)
    0.9999999999193593,
    -4.934802189554386,
    4.0587118821364125,
    -1.3352607094469389,
    0.23532212897176416,
    -0.025787854657773987,
    0.001905911958441571,
    -8.916973037465991e-05,
)
_INV_2PI = float(1.0 / (2.0 * np.pi))
_TWO_PI = float(2.0 * np.pi)
_INV_PI = float(1.0 / np.pi)


def _fast_sincos(x):
    """(cos x, sin x) via one shared range reduction + Horner pair (~21
    FMA-class ops for both)."""
    r = x - _TWO_PI * jnp.floor(x * _INV_2PI + 0.5)
    t = r * _INV_PI
    t2 = t * t
    ps = _FAST_SIN_COEFFS[-1]
    for c in _FAST_SIN_COEFFS[-2::-1]:
        ps = ps * t2 + c
    pc = _FAST_COS_COEFFS[-1]
    for c in _FAST_COS_COEFFS[-2::-1]:
        pc = pc * t2 + c
    return pc, ps * t


def pallas_interpret(backend: str | None = None) -> bool:
    """Whether Pallas kernels run in interpret mode on ``backend`` (default:
    JAX's default backend). The one place that decides: compiled on the GPU,
    interpreted on the CPU (which serves tests and rehearsals only); any
    other backend has no route for these kernels and raises."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas route for backend {backend!r}: the kernels compile for the "
        "GPU through Triton and run in interpret mode on the CPU"
    )


def _lin(*terms):
    """Sum of ``c * x`` over ``(c, x)`` pairs; a ``None`` coefficient is a
    structural zero, dropped at trace time."""
    out = None
    for c, x in terms:
        if c is None:
            continue
        out = c * x if out is None else out + c * x
    return out


def _check_tile(tile_s: int, tile_l: int, interpret: bool) -> None:
    tile = tile_s * tile_l
    if tile < 1 or tile & (tile - 1):
        raise ValueError(
            f"tile {tile_s}x{tile_l} = {tile} scenarios is not a power of two "
            "(Triton's block sizes are)"
        )
    if not interpret and tile_l % 32:
        raise ValueError(
            f"compiled kernels take tile_l a multiple of 32 (one warp per row "
            f"of scenarios), got {tile_l}"
        )


def _bank_call(kernel, ins, out_leads, *, tile_s, tile_l, interpret, name):
    """Run ``kernel`` over a scenario-minor bank: every input is an
    ``(..., B)`` float32 plane stack, every output an ``(*lead, B)`` one. The
    grid is one program per ``(tile_s, tile_l)`` block of scenarios."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B = ins[0].shape[-1]
    rows = B // tile_l

    def spec(lead):
        lead = tuple(lead)
        return pl.BlockSpec(lead + (tile_s, tile_l), lambda i: (0,) * len(lead) + (i, 0))

    outs = pl.pallas_call(
        kernel,
        grid=(rows // tile_s,),
        in_specs=[spec(a.shape[:-1]) for a in ins],
        out_specs=[spec(lead) for lead in out_leads],
        out_shape=[
            jax.ShapeDtypeStruct(tuple(lead) + (rows, tile_l), jnp.float32)
            for lead in out_leads
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=tile_s, num_stages=1),
        interpret=interpret,
        name=name,
    )(*[a.reshape(a.shape[:-1] + (rows, tile_l)) for a in ins])
    return [o.reshape(o.shape[:-2] + (B,)) for o in outs]


# parameter planes shared by both problems (rows of the ``par`` input)
_X0, _Q, _R, _RF, _OW, _INV_IR2, _N_LIVE, _EXTRA = 0, 3, 6, 8, 9, 10, 11, 12
_N_PAR = 15  # + 3 extra planes: goal pose (point) | terminal weights (tracking)
# workspace slots per stage: feedforward (2), feedback gains (2x3), best
# line-search candidate (2)
_KFF, _KFB, _UBEST, _N_WS = 0, 2, 8, 10


def _make_solver(
    ocp: OCP,
    settings: SolverSettings,
    *,
    tracking: bool,
    wrap_yaw: bool,
    interpret,
    tile_s: int,
    tile_l: int,
    stage_tol: float,
    with_counters: bool,
):
    if interpret is None:
        interpret = pallas_interpret()
    _check_tile(tile_s, tile_l, interpret)
    N = ocp.horizon
    # the OCP closes over dt; recover it by probing the transition once
    dt = float(ocp.transition(jnp.zeros(3), jnp.array([0.0, 1.0]))[2])
    lo_v, lo_w = (float(v) for v in np.asarray(ocp.u_lo, dtype=np.float32))
    hi_v, hi_w = (float(v) for v in np.asarray(ocp.u_hi, dtype=np.float32))
    eps_v, eps_w = (
        float(e)
        for e in (settings.interior_clip * (np.asarray(ocp.u_hi) - np.asarray(ocp.u_lo)))
        .astype(np.float32)
    )
    ips = settings.iters_per_stage
    n_iters = settings.total_iters
    # geometric barrier schedule, held constant within a stage
    log_mu0 = math.log(settings.mu_init)
    log_mu_step = (
        (math.log(settings.mu_final) - log_mu0) / (settings.barrier_stages - 1)
        if settings.barrier_stages > 1
        else 0.0
    )
    c1 = settings.armijo_c1

    def wyaw(e):
        # corrected-mode yaw error wrap to (-pi, pi]: gradient 1 a.e.
        if not wrap_yaw:
            return e
        return e - _TWO_PI * jnp.floor(e * _INV_2PI + 0.5)

    def kernel(*refs):
        if tracking:
            par, obs, u0, rref, U, X, stats, ws = refs
        else:
            par, obs, u0, U, X, stats, ws = refs
        px0, py0, th0 = par[_X0], par[_X0 + 1], par[_X0 + 2]
        Q0, Q1, Q2 = par[_Q], par[_Q + 1], par[_Q + 2]
        R0, R1 = par[_R], par[_R + 1]
        rf, ow, inv_ir2 = par[_RF], par[_OW], par[_INV_IR2]
        e0, e1, e2 = par[_EXTRA], par[_EXTRA + 1], par[_EXTRA + 2]
        z = jnp.zeros_like(px0)

        # Obstacle terms are the kernel's FLOP majority. Two dynamic cuts,
        # both bit-exact: a block whose obstacle weight is all zero (the
        # reference-parity formulation, open-floor banks) skips them; and the
        # node layer pads obstacle vectors with far sentinels whose Gaussian
        # underflows to exactly 0.0, the live points forming a prefix — the
        # wrapper passes each scenario's live-prefix length, and the loop
        # stops after the block's last live chunk.
        has_obs = jnp.max(jnp.abs(ow)) > 0.0
        n_chunks = jax.lax.div(
            jnp.max(par[_N_LIVE]).astype(jnp.int32) + (OBS_CHUNK - 1), OBS_CHUNK
        )

        def obstacle(px, py, order):
            """``order`` 0: value; 1: gradient (gx, gy); 2: gradient and
            Hessian (gx, gy, hxx, hxy, hyy) of ow * sum_j exp(-r_j^2/ir^2)."""
            n_out = (1, 2, 5)[order]
            zeros = tuple(z for _ in range(n_out))
            i2 = inv_ir2
            g2 = -2.0 * i2
            h4 = 4.0 * i2 * i2

            def chunk(ci, acc):
                for j in range(OBS_CHUNK):
                    dx = px - obs[0, ci * OBS_CHUNK + j]
                    dy = py - obs[1, ci * OBS_CHUNK + j]
                    e = ow * jnp.exp(-(dx * dx + dy * dy) * i2)
                    if order == 0:
                        acc = (acc[0] + e,)
                        continue
                    terms = (g2 * dx * e, g2 * dy * e)
                    if order == 2:
                        terms += (
                            e * (h4 * dx * dx - 2.0 * i2),
                            e * h4 * dx * dy,
                            e * (h4 * dy * dy - 2.0 * i2),
                        )
                    acc = tuple(a + t for a, t in zip(acc, terms))
                return acc

            out = jax.lax.cond(
                has_obs,
                lambda: jax.lax.fori_loop(0, n_chunks, chunk, zeros),
                lambda: zeros,
            )
            return out[0] if order == 0 else out

        def refs_at(k):
            """(x_ref, y_ref, yaw_ref, v_ref, w_ref) at stage k; ``None`` is
            a zero reference (point stabilization's controls)."""
            if tracking:
                return tuple(rref[k, c] for c in range(5))
            return e0, e1, e2, None, None

        def errors(k, px, py, th, v, w):
            rx, ry, rth, rv, rw = refs_at(k)
            return (
                px - rx,
                py - ry,
                wyaw(th - rth),
                v if rv is None else v - rv,
                w if rw is None else w - rw,
            )

        def F(px, py, th, v, w):
            if tracking:
                c, s = _fast_sincos(th)
                return px + dt * v * c, py + dt * v * s, th + dt * w
            th4 = th + dt * w
            c0, s0 = _fast_sincos(th)
            c2, s2 = _fast_sincos(th + 0.5 * dt * w)
            c4, s4 = _fast_sincos(th4)
            c = (dt / 6.0) * (c0 + 4.0 * c2 + c4)
            s = (dt / 6.0) * (s0 + 4.0 * s2 + s4)
            return px + v * c, py + v * s, th4

        def F_jac(px, py, th, v, w):
            """(a02, a12, bc, bsn, b01, b11): A = [[1,0,a02],[0,1,a12],[0,0,1]],
            B = [[bc,b01],[bsn,b11],[0,dt]]; b01/b11 None under Euler."""
            if tracking:
                c, s = _fast_sincos(th)
                return -dt * v * s, dt * v * c, dt * c, dt * s, None, None
            c0, s0 = _fast_sincos(th)
            c2, s2 = _fast_sincos(th + 0.5 * dt * w)
            c4, s4 = _fast_sincos(th + dt * w)
            C = (dt / 6.0) * (c0 + 4.0 * c2 + c4)
            S = (dt / 6.0) * (s0 + 4.0 * s2 + s4)
            # d th_i/d th = 1; d th2/dw = dt/2, d th4/dw = dt
            b01 = -(v * dt / 6.0) * (4.0 * s2 * (0.5 * dt) + s4 * dt)
            b11 = (v * dt / 6.0) * (4.0 * c2 * (0.5 * dt) + c4 * dt)
            return -v * S, v * C, C, S, b01, b11

        def barrier(v, w, mu):
            return -mu * (
                jnp.log(v - lo_v) + jnp.log(hi_v - v) + jnp.log(w - lo_w) + jnp.log(hi_w - w)
            )

        def stage_cost(k, px, py, th, v, w, mu):
            """Stage cost; ``mu=None`` is the true cost (no barrier)."""
            ex, ey, eth, ev, ew = errors(k, px, py, th, v, w)
            c = Q0 * ex * ex + Q1 * ey * ey + Q2 * eth * eth
            c = c + R0 * ev * ev + R1 * ew * ew + jnp.exp(-rf * v)
            c = c + obstacle(px, py, 0)
            return c if mu is None else c + barrier(v, w, mu)

        def terminal_errors(px, py, th):
            return px - rref[N - 1, 0], py - rref[N - 1, 1], wyaw(th - rref[N - 1, 2])

        def terminal_cost(px, py, th):
            """Tracking's stage-N obstacle term + the optional terminal pose
            quadratic ``||x_N - x_ref[N-1]||^2_W`` (zero W under parity —
            reference quirk #5); point stabilization has none."""
            if not tracking:
                return z
            ex, ey, eth = terminal_errors(px, py, th)
            return obstacle(px, py, 0) + (e0 * ex * ex + e1 * ey * ey + e2 * eth * eth)

        def clip_interior(v, w):
            return (
                jnp.clip(v, lo_v + eps_v, hi_v - eps_v),
                jnp.clip(w, lo_w + eps_w, hi_w - eps_w),
            )

        # ---- initialize U strictly interior ----
        def init_u(k, carry):
            U[k, 0] = jnp.clip(u0[k, 0], lo_v + 1e-3 * (hi_v - lo_v), hi_v - 1e-3 * (hi_v - lo_v))
            U[k, 1] = jnp.clip(u0[k, 1], lo_w + 1e-3 * (hi_w - lo_w), hi_w - 1e-3 * (hi_w - lo_w))
            return carry

        jax.lax.fori_loop(0, N, init_u, 0)

        def rollout_cost(mu):
            """Roll U from x0 into X; return the (barrier, unless ``mu`` is
            None) cost."""
            X[0, 0], X[0, 1], X[0, 2] = px0, py0, th0

            def body(k, carry):
                px, py, th, acc = carry
                v, w = U[k, 0], U[k, 1]
                acc = acc + stage_cost(k, px, py, th, v, w, mu)
                px, py, th = F(px, py, th, v, w)
                X[k + 1, 0], X[k + 1, 1], X[k + 1, 2] = px, py, th
                return px, py, th, acc

            px, py, th, acc = jax.lax.fori_loop(0, N, body, (px0, py0, th0, z))
            return acc + terminal_cost(px, py, th)

        def backward(mu, reg):
            """Riccati sweep (l_ux == 0 by separability); stores the gains
            in the workspace and returns the expected decrease (dV1, dV2)."""
            if tracking:
                xN, yN, thN = X[N, 0], X[N, 1], X[N, 2]
                tgx, tgy, thxx, thxy, thyy = obstacle(xN, yN, 2)
                ex, ey, eth = terminal_errors(xN, yN, thN)
                init = (
                    tgx + 2.0 * e0 * ex,
                    tgy + 2.0 * e1 * ey,
                    2.0 * e2 * eth,
                    thxx + 2.0 * e0,
                    thxy,
                    z,
                    thyy + 2.0 * e1,
                    z,
                    2.0 * e2 + z,
                    z,
                    z,
                )
            else:
                init = tuple(z for _ in range(11))

            def step(i, carry):
                k = N - 1 - i
                vx0, vx1, vx2, v00, v01, v02, v11, v12, v22, dV1, dV2 = carry
                px, py, th = X[k, 0], X[k, 1], X[k, 2]
                v, w = U[k, 0], U[k, 1]
                a02, a12, bc, bsn, b01, b11 = F_jac(px, py, th, v, w)

                # cost derivatives
                ogx, ogy, ohxx, ohxy, ohyy = obstacle(px, py, 2)
                ex, ey, eth, ev, ew = errors(k, px, py, th, v, w)
                lx0 = 2.0 * Q0 * ex + ogx
                lx1 = 2.0 * Q1 * ey + ogy
                lx2 = 2.0 * Q2 * eth
                er = jnp.exp(-rf * v)
                sv_lo, sv_hi = v - lo_v, hi_v - v
                sw_lo, sw_hi = w - lo_w, hi_w - w
                lu0 = 2.0 * R0 * ev - rf * er - mu * (1.0 / sv_lo - 1.0 / sv_hi)
                lu1 = 2.0 * R1 * ew - mu * (1.0 / sw_lo - 1.0 / sw_hi)
                lxx00 = 2.0 * Q0 + ohxx
                lxx11 = 2.0 * Q1 + ohyy
                lxx22 = 2.0 * Q2
                luu00 = 2.0 * R0 + rf * rf * er + mu * (1.0 / (sv_lo * sv_lo) + 1.0 / (sv_hi * sv_hi))
                luu11 = 2.0 * R1 + mu * (1.0 / (sw_lo * sw_lo) + 1.0 / (sw_hi * sw_hi))

                # Qx = lx + A^T Vx ; Qu = lu + B^T Vx
                qx0 = lx0 + vx0
                qx1 = lx1 + vx1
                qx2 = lx2 + a02 * vx0 + a12 * vx1 + vx2
                qu0 = lu0 + bc * vx0 + bsn * vx1
                qu1 = lu1 + _lin((b01, vx0), (b11, vx1), (dt, vx2))

                # Vxx A; A's columns: [e0, e1, (a02, a12, 1)]
                va02 = v00 * a02 + v01 * a12 + v02
                va12 = v01 * a02 + v11 * a12 + v12
                va22 = v02 * a02 + v12 * a12 + v22
                # Qxx = lxx + A^T (Vxx A)
                q00 = lxx00 + v00
                q01 = ohxy + v01
                q02 = va02
                q11 = lxx11 + v11
                q12 = va12
                q22 = lxx22 + a02 * va02 + a12 * va12 + va22

                # Vxx B; B's columns: b_v = (bc, bsn, 0), b_w = (b01, b11, dt)
                vb00 = v00 * bc + v01 * bsn
                vb10 = v01 * bc + v11 * bsn
                vb01 = _lin((b01, v00), (b11, v01), (dt, v02))
                vb11 = _lin((b01, v01), (b11, v11), (dt, v12))
                vb21 = _lin((b01, v02), (b11, v12), (dt, v22))
                # Quu = luu + B^T Vxx B (+ reg)
                quu00 = luu00 + bc * vb00 + bsn * vb10 + reg
                quu01 = bc * vb01 + bsn * vb11
                quu11 = luu11 + _lin((b01, vb01), (b11, vb11), (dt, vb21)) + reg
                # Qux = B^T Vxx A (l_ux = 0)
                qux00 = bc * v00 + bsn * v01
                qux01 = bc * v01 + bsn * v11
                qux02 = bc * va02 + bsn * va12
                qux10 = vb01
                qux11 = vb11
                qux12 = _lin((b01, va02), (b11, va12), (dt, va22))

                det = quu00 * quu11 - quu01 * quu01
                bad = jnp.logical_or(det <= 1e-12, jnp.minimum(quu00, quu11) <= 0.0)
                quu00 = jnp.where(bad, quu00 + 1e3, quu00)
                quu11 = jnp.where(bad, quu11 + 1e3, quu11)
                det = jnp.where(bad, quu00 * quu11 - quu01 * quu01, det)
                inv_det = 1.0 / det

                def solve2(r0, r1):
                    return (
                        (quu11 * r0 - quu01 * r1) * inv_det,
                        (quu00 * r1 - quu01 * r0) * inv_det,
                    )

                kf0, kf1 = solve2(-qu0, -qu1)
                K00, K10 = solve2(-qux00, -qux10)
                K01, K11 = solve2(-qux01, -qux11)
                K02, K12 = solve2(-qux02, -qux12)
                for slot, val in enumerate((kf0, kf1, K00, K01, K02, K10, K11, K12)):
                    ws[k, _KFF + slot] = val

                # Vx' = Qx + K^T Quu kff + K^T Qu + Qux^T kff
                qk0 = quu00 * kf0 + quu01 * kf1
                qk1 = quu01 * kf0 + quu11 * kf1
                nvx0 = qx0 + K00 * qk0 + K10 * qk1 + K00 * qu0 + K10 * qu1 + qux00 * kf0 + qux10 * kf1
                nvx1 = qx1 + K01 * qk0 + K11 * qk1 + K01 * qu0 + K11 * qu1 + qux01 * kf0 + qux11 * kf1
                nvx2 = qx2 + K02 * qk0 + K12 * qk1 + K02 * qu0 + K12 * qu1 + qux02 * kf0 + qux12 * kf1

                # Vxx' = Qxx + K^T Quu K + K^T Qux + Qux^T K (symmetrized)
                qkK0 = quu00 * K00 + quu01 * K10
                qkK1 = quu01 * K00 + quu11 * K10
                qkK0b = quu00 * K01 + quu01 * K11
                qkK1b = quu01 * K01 + quu11 * K11
                qkK0c = quu00 * K02 + quu01 * K12
                qkK1c = quu01 * K02 + quu11 * K12
                n00 = q00 + K00 * qkK0 + K10 * qkK1 + 2.0 * (K00 * qux00 + K10 * qux10)
                n01 = q01 + K00 * qkK0b + K10 * qkK1b + (K00 * qux01 + K10 * qux11) + (K01 * qux00 + K11 * qux10)
                n02 = q02 + K00 * qkK0c + K10 * qkK1c + (K00 * qux02 + K10 * qux12) + (K02 * qux00 + K12 * qux10)
                n11 = q11 + K01 * qkK0b + K11 * qkK1b + 2.0 * (K01 * qux01 + K11 * qux11)
                n12 = q12 + K01 * qkK0c + K11 * qkK1c + (K01 * qux02 + K11 * qux12) + (K02 * qux01 + K12 * qux11)
                n22 = q22 + K02 * qkK0c + K12 * qkK1c + 2.0 * (K02 * qux02 + K12 * qux12)

                dV1 = dV1 + kf0 * qu0 + kf1 * qu1
                dV2 = dV2 + 0.5 * (kf0 * qk0 + kf1 * qk1)
                return (nvx0, nvx1, nvx2, n00, n01, n02, n11, n12, n22, dV1, dV2)

            out = jax.lax.fori_loop(0, N, step, init)
            return out[9], out[10]

        def line_search(mu, J, dV1, dV2, n_ls):
            """Alphas descending, per-scenario first accept; once every
            scenario of the block has accepted the remaining candidate
            rollouts are skipped. Returns (accept mask, n_ls). Rejected
            candidates left in the workspace's best slot are overwritten by
            the next alpha or masked out by the commit — never read."""

            def try_alpha(a, carry):
                def attempt(carry):
                    accepted, n_ls, alpha = carry
                    take = accepted < 0.5

                    def body(k, c):
                        px, py, th, Jc = c
                        dx0 = px - X[k, 0]
                        dx1 = py - X[k, 1]
                        dx2 = th - X[k, 2]
                        g = [ws[k, _KFB + j] for j in range(6)]
                        v = U[k, 0] + alpha * ws[k, _KFF] + (g[0] * dx0 + g[1] * dx1 + g[2] * dx2)
                        w = U[k, 1] + alpha * ws[k, _KFF + 1] + (g[3] * dx0 + g[4] * dx1 + g[5] * dx2)
                        v, w = clip_interior(v, w)
                        Jc = Jc + stage_cost(k, px, py, th, v, w, mu)
                        ws[k, _UBEST] = jnp.where(take, v, ws[k, _UBEST])
                        ws[k, _UBEST + 1] = jnp.where(take, w, ws[k, _UBEST + 1])
                        px, py, th = F(px, py, th, v, w)
                        return px, py, th, Jc

                    cx, cy, cth, Jc = jax.lax.fori_loop(0, N, body, (px0, py0, th0, z))
                    Jc = Jc + terminal_cost(cx, cy, cth)
                    expected = -(alpha * dV1 + alpha * alpha * dV2)
                    Jc = jnp.where(jnp.isnan(Jc), jnp.inf, Jc)
                    ok = Jc <= J - c1 * jnp.maximum(expected, 0.0)
                    newly = jnp.where(jnp.logical_and(ok, take), 1.0, 0.0)
                    return jnp.maximum(accepted, newly), n_ls + 1, alpha

                accepted, n_ls, alpha = jax.lax.cond(
                    jnp.min(carry[0]) < 0.5, attempt, lambda c: c, carry
                )
                return accepted, n_ls, 0.5 * alpha

            accepted, n_ls, _ = jax.lax.fori_loop(
                0, settings.n_alphas, try_alpha, (z, n_ls, jnp.float32(1.0))
            )
            return accepted > 0.5, n_ls

        def iteration(t, carry):
            stage = jax.lax.div(t, ips)  # t >= 0: plain integer division

            def run(carry):
                reg, done, n_it, n_ls = carry
                mu = jnp.exp(log_mu0 + stage.astype(jnp.float32) * log_mu_step)
                J = rollout_cost(mu)
                dV1, dV2 = backward(mu, reg)
                # Stage-level early exit: the Newton decrement -(dV1+dV2)
                # decays quadratically within a barrier stage; once the whole
                # block is below stage_tol*(1+|J|), the stage's remaining
                # iterations are no-ops. Never on a stage's first iteration
                # (a fresh mu resets the decrement).
                dec = -(dV1 + dV2)
                stage_done = jnp.logical_and(
                    jax.lax.rem(t, ips) != 0, jnp.max(dec - stage_tol * (1.0 + jnp.abs(J))) < 0.0
                )
                done = jnp.where(stage_done, stage + 1, done)
                accept, n_ls = line_search(mu, J, dV1, dV2, n_ls)

                def commit(k, c):
                    U[k, 0] = jnp.where(accept, ws[k, _UBEST], U[k, 0])
                    U[k, 1] = jnp.where(accept, ws[k, _UBEST + 1], U[k, 1])
                    return c

                jax.lax.fori_loop(0, N, commit, 0)
                reg = jnp.where(
                    accept,
                    jnp.maximum(reg * 0.5, settings.reg_min),
                    jnp.minimum(reg * 10.0 + settings.reg_min, settings.reg_max),
                )
                return reg, done, n_it + 1, n_ls

            return jax.lax.cond(carry[1] <= stage, run, lambda c: c, carry)

        zero_i = jnp.int32(0)
        _, _, n_it, n_ls = jax.lax.fori_loop(
            0, n_iters, iteration, (z + settings.reg_init, zero_i, zero_i, zero_i)
        )

        # ---- final rollout, true cost, adjoint KKT residual ----
        Jtrue = rollout_cost(None)

        def adjoint(i, carry):
            k = N - 1 - i
            l0, l1, l2, kkt = carry
            px, py, th = X[k, 0], X[k, 1], X[k, 2]
            v, w = U[k, 0], U[k, 1]
            a02, a12, bc, bsn, b01, b11 = F_jac(px, py, th, v, w)
            ogx, ogy = obstacle(px, py, 1)
            ex, ey, eth, ev, ew = errors(k, px, py, th, v, w)
            er = jnp.exp(-rf * v)
            gu0 = 2.0 * R0 * ev - rf * er + bc * l0 + bsn * l1
            gu1 = 2.0 * R1 * ew + _lin((b01, l0), (b11, l1), (dt, l2))
            # projected-gradient residual per control
            r0 = jnp.abs(v - jnp.clip(v - gu0, lo_v, hi_v))
            r1 = jnp.abs(w - jnp.clip(w - gu1, lo_w, hi_w))
            kkt = jnp.maximum(kkt, jnp.maximum(r0, r1))
            n0 = 2.0 * Q0 * ex + ogx + l0
            n1 = 2.0 * Q1 * ey + ogy + l1
            n2 = 2.0 * Q2 * eth + a02 * l0 + a12 * l1 + l2
            return n0, n1, n2, kkt

        if tracking:
            xN, yN, thN = X[N, 0], X[N, 1], X[N, 2]
            agx, agy = obstacle(xN, yN, 1)
            ex, ey, eth = terminal_errors(xN, yN, thN)
            lam = (agx + 2.0 * e0 * ex, agy + 2.0 * e1 * ey, 2.0 * e2 * eth, z)
        else:
            lam = (z, z, z, z)
        _, _, _, kkt = jax.lax.fori_loop(0, N, adjoint, lam)

        stats[0] = Jtrue
        stats[1] = kkt
        stats[2] = z + n_it.astype(jnp.float32)
        stats[3] = z + n_ls.astype(jnp.float32)

    tile = tile_s * tile_l
    name = "tracking_solver" if tracking else "point_stab_solver"

    def solve_bank(thetas, U0s):
        B = U0s.shape[0]
        if B % tile:
            raise ValueError(f"bank size {B} must be a multiple of the tile {tile_s}x{tile_l}")

        def plane(a):  # (B, ...) -> (..., B) float32
            return jnp.moveaxis(jnp.asarray(a, jnp.float32), 0, -1)

        obs_x = jnp.asarray(thetas["obs_x"], jnp.float32)
        obs_y = jnp.asarray(thetas["obs_y"], jnp.float32)
        pad = (-obs_x.shape[1]) % OBS_CHUNK
        obs_x = jnp.pad(obs_x, ((0, 0), (0, pad)), constant_values=FAR)
        obs_y = jnp.pad(obs_y, ((0, 0), (0, pad)), constant_values=FAR)
        # live-prefix length: points within +-90 m are live (workspaces are
        # tens of meters; the sentinels sit at 100 m)
        live = jnp.logical_or(jnp.abs(obs_x) < 90.0, jnp.abs(obs_y) < 90.0)
        n_live = jnp.max(jnp.where(live, jnp.arange(1, obs_x.shape[1] + 1), 0), axis=1)
        if tracking:
            extra = thetas.get("terminal_weight", jnp.zeros((B, 3), jnp.float32))
        else:
            extra = thetas["goal"]
        par = jnp.concatenate(
            [
                plane(thetas["x0"]),
                plane(thetas["Q"]),
                plane(thetas["R"]),
                plane(thetas["reverse_factor"])[None],
                plane(thetas["obstacle_weight"] * thetas["obstacle_gain"])[None],
                plane(1.0 / (thetas["inflation_radius"] ** 2))[None],
                plane(n_live)[None],
                plane(extra),
            ]
        )  # (_N_PAR, B)
        ins = [par, jnp.stack([plane(obs_x), plane(obs_y)]), plane(U0s)]
        if tracking:
            ins.append(plane(jnp.concatenate([thetas["x_ref"], thetas["u_ref"]], axis=-1)))
        U, X, stats, _ = _bank_call(
            kernel,
            ins,
            [(N, 2), (N + 1, 3), (4,), (N, _N_WS)],
            tile_s=tile_s,
            tile_l=tile_l,
            interpret=interpret,
            name=name,
        )
        kkt = stats[1]
        iters = stats[2].astype(jnp.int32)
        sol = Solution(
            U=jnp.moveaxis(U, -1, 0),
            X=jnp.moveaxis(X, -1, 0),
            cost=stats[0],
            kkt_residual=kkt,
            converged=kkt < settings.kkt_tol,
            n_iters=iters,
            reg=jnp.zeros((B,)),
        )
        if with_counters:
            return sol, {"iters": iters, "ls_rollouts": stats[3].astype(jnp.int32)}
        return sol

    return solve_bank


def make_pallas_point_stab_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    interpret: bool | None = None,
    tile_s: int = TILE_S,
    tile_l: int = TILE_L,
    stage_tol: float = 1e-10,
    with_counters: bool = False,
):
    """Build ``solve_bank(thetas, U0s) -> Solution`` (B-leading; B a multiple
    of ``tile_s * tile_l``, a power of two).

    ``ocp`` must be a point-stabilization template from
    :func:`~ros2_mpc_jax.solver.problems.make_point_stabilization` (the
    kernel hard-codes that problem structure; the generic engines cover the
    rest). ``interpret`` defaults to :func:`pallas_interpret`.

    ``stage_tol``: stage-level early exit — once every scenario in a block
    has Newton decrement ``-(dV1+dV2) < stage_tol * (1+|J|)`` at the current
    barrier stage (never on a stage's first iteration), the stage's remaining
    iterations are skipped. At 1e-10 the skipped steps move U by ~1e-5 —
    inside the engines' mutual 1e-4 parity band (tests/test_pallas.py).

    ``Solution.n_iters`` reports the iterations each scenario's block
    actually executed. With ``with_counters=True`` the solver returns
    ``(Solution, counters)`` where ``counters = {"iters": (B,),
    "ls_rollouts": (B,)}`` — the executed solver-iteration and
    line-search-candidate-rollout counts per scenario's block, the inputs to
    the op accounting (:mod:`ros2_mpc_jax.utils.roofline`).
    """
    return _make_solver(
        ocp,
        settings,
        tracking=False,
        wrap_yaw=False,
        interpret=interpret,
        tile_s=tile_s,
        tile_l=tile_l,
        stage_tol=stage_tol,
        with_counters=with_counters,
    )


def make_pallas_tracking_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    interpret: bool | None = None,
    tile_s: int = TILE_S,
    tile_l: int = TILE_L,
    stage_tol: float = 1e-10,
    with_counters: bool = False,
    wrap_yaw: bool | None = None,
):
    """Whole-solver kernel for the trajectory-tracking formulation
    (make_tracking): Euler transition (quirk #3), time-varying x/u references
    (quirk #4 indexing handled by the theta builder), Gaussian obstacle term
    (weighted; 0 under parity), reverse penalty, optional terminal pose
    quadratic ``||x_N - x_ref[N-1]||^2_W`` (the corrected parking mode; zero
    weights reproduce parity exactly), log-barrier bounds. Same layout,
    options and algorithm as :func:`make_pallas_point_stab_solver`.

    ``wrap_yaw`` (default: read from ``ocp.meta``, set by make_tracking's
    corrected mode) wraps the yaw tracking error to (-pi, pi] in the cost,
    its analytic gradients, and the KKT adjoint — mirroring the OCP's
    corrected-mode stage cost so engine cross-parity holds."""
    if wrap_yaw is None:
        wrap_yaw = "wrap_yaw" in getattr(ocp, "meta", ())
    return _make_solver(
        ocp,
        settings,
        tracking=True,
        wrap_yaw=wrap_yaw,
        interpret=interpret,
        tile_s=tile_s,
        tile_l=tile_l,
        stage_tol=stage_tol,
        with_counters=with_counters,
    )
