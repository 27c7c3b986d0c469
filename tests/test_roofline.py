"""Roofline accounting: ledger sanity, live-prefix reproduction, counters.

The achieved-rate numbers themselves come from chip runs (bench.py); here we pin
the pieces that must be *correct* rather than fast: the analytic ledgers'
scaling structure, the kernel-matching obstacle-point model, and the
executed-work counters the achieved-FLOPs number is built from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import make_point_stabilization
from ros2_mpc_jax.solver.pallas_kernel import make_pallas_point_stab_solver
from ros2_mpc_jax.utils import roofline as rl


def test_ledgers_scale_and_vectorize():
    base = rl.point_stab_solve_flops(20, 0.0, 60, 180)
    assert base.arith > 0 and base.exp > 0 and base.log > 0 and base.sincos > 0
    # linear in executed iterations (holding everything else fixed)
    double_i = rl.point_stab_solve_flops(20, 0.0, 120, 180)
    per_iter = rl.point_stab_solve_flops(20, 0.0, 1, 0)
    assert double_i.arith - base.arith == pytest.approx(60 * (per_iter.arith - rl.point_stab_solve_flops(20, 0.0, 0, 0).arith))
    # obstacles only add work
    with_obs = rl.point_stab_solve_flops(20, 8.0, 60, 180)
    assert with_obs.arith > base.arith and with_obs.exp > base.exp
    # vectorized over a bank == sum of scalars
    iters = np.array([60.0, 30.0])
    ls = np.array([180.0, 90.0])
    total = rl.bank_flops(rl.point_stab_solve_flops, 20, np.zeros(2), iters, ls)
    a = rl.point_stab_solve_flops(20, 0.0, 60, 180)
    b = rl.point_stab_solve_flops(20, 0.0, 30, 90)
    assert total.total_flops == pytest.approx(a.total_flops + b.total_flops)
    # tracking ledger has the same shape properties
    tr = rl.tracking_solve_flops(20, 0.0, 60, 180)
    assert 0 < tr.sincos < base.sincos  # Euler needs 3x fewer trig than RK4
    # fast_sincos accounting: sincos ops convert to arith at 10.5 each
    fast = rl.point_stab_solve_flops(20, 0.0, 60, 180, fast_sincos=True)
    assert fast.sincos == 0.0
    assert fast.arith == pytest.approx(base.arith + base.sincos * 10.5)
    assert fast.exp == base.exp and fast.log == base.log


def test_computed_obstacle_points_matches_kernel_model():
    B, n_obs = 8, 160
    far = np.full((B, n_obs), 100.0)
    # zero weight -> dynamic skip, zero points computed
    assert rl.computed_obstacle_points(far, far, np.zeros(B), tile_s=2, tile_l=4).sum() == 0
    # 3 live points -> one 8-point chunk for every scenario in the tile
    ox = far.copy()
    ox[0, :3] = 1.0
    oy = far.copy()
    oy[0, :3] = 1.0
    out = rl.computed_obstacle_points(ox, oy, np.ones(B), tile_s=2, tile_l=4)
    assert np.all(out == 8.0)  # tile-wide max prefix, ceil(3/8)*8
    # live point deeper in the vector extends the prefix for its whole tile
    ox[3, 17] = 2.0
    out = rl.computed_obstacle_points(ox, oy, np.ones(B), tile_s=2, tile_l=4)
    assert np.all(out == 24.0)  # ceil(18/8)*8


def test_kernel_counters_interpret():
    params = Params()
    N, B = 8, 8
    prob = make_point_stabilization(params, horizon=N)
    solve = make_pallas_point_stab_solver(
        prob.ocp, prob.settings, interpret=True, tile_s=2, tile_l=4, with_counters=True
    )
    rng = np.random.default_rng(0)
    th = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3))),
        jnp.asarray(rng.uniform(-1.0, 1.0, (B, 3))),
    )
    sol, cnt = solve(th, jnp.zeros((B, N, 2)))
    iters = np.asarray(cnt["iters"])
    ls = np.asarray(cnt["ls_rollouts"])
    assert iters.shape == (B,) and ls.shape == (B,)
    assert np.all(iters >= 1) and np.all(iters <= prob.settings.total_iters)
    # every executed iteration tries at least one line-search candidate
    assert np.all(ls >= iters)
    assert np.all(ls <= iters * prob.settings.n_alphas)
    # Solution.n_iters now reports executed iterations, same numbers
    assert np.array_equal(np.asarray(sol.n_iters), iters)


def test_measure_vpu_peaks_interpret_smoke():
    """The op-class rate chains are plain jitted jnp/lax code: they run on
    the CPU backend as they would on the GPU."""
    rates = rl.measure_xla_op_rates(rows=8, cols=128, target_s=1e-3)
    for k in ("fma_flops_per_s", "exp_per_s", "log_per_s", "sincos_per_s"):
        assert rates[k] > 0

    count = rl.point_stab_solve_flops(20, 8.0, 60, 180)
    rep = rl.roofline_report(count, 1e-6, rates, hbm_bytes=rl.point_stab_hbm_bytes(20, 160))
    assert rep["achieved_gflops"] > 0
    assert 0 < rep["transcendental_frac"] < 1
    assert rep["arithmetic_intensity_flops_per_byte"] > 10  # compute-bound


def test_phase_ledger_sums_to_total():
    """The per-phase split must reproduce the whole-solve ledger exactly,
    for scalar and (B,)-array counters, in both sincos modes."""
    rng = np.random.default_rng(3)
    for fast in (False, True):
        for I, R, P in [(60.0, 180.0, 8.0), (rng.uniform(5, 60, 16), rng.uniform(10, 300, 16), rng.uniform(0, 16, 16))]:
            total = rl.point_stab_solve_flops(20, P, I, R, fast_sincos=fast)
            phases = rl.point_stab_phase_flops(20, P, I, R, fast_sincos=fast)
            agg = None
            for c in phases.values():
                agg = c if agg is None else agg + c
            np.testing.assert_allclose(np.asarray(agg.arith), np.asarray(total.arith), rtol=1e-12)
            np.testing.assert_allclose(np.asarray(agg.exp), np.asarray(total.exp), rtol=1e-12)
            np.testing.assert_allclose(np.asarray(agg.log), np.asarray(total.log), rtol=1e-12)
            np.testing.assert_allclose(np.asarray(agg.sincos), np.asarray(total.sincos), rtol=1e-12)


def test_phase_model_seconds_and_loop_trips():
    rates = {"fma_flops_per_s": 3e12, "exp_per_s": 1.3e12, "log_per_s": 1.3e12, "sincos_per_s": 7e10}
    phases = rl.bank_phase_flops(20, np.full(8, 8.0), np.full(8, 60.0), np.full(8, 180.0))
    secs = rl.phase_model_seconds(phases, rates)
    assert set(secs) == {"rollout", "backward", "line_search", "final"}
    assert all(v > 0 for v in secs.values())
    # backward dominates the model (361 arith/step vs 46)
    assert secs["backward"] > secs["rollout"]
    trips = rl.solver_loop_trips(20, 60.0, 180.0)
    assert trips == 60.0 * 3 * 20 + 180.0 * 20 + 3 * 20


def test_measure_loop_overhead_interpret_smoke():
    ov = rl.measure_loop_overhead(rows=8, cols=128)
    assert ov >= 0.0
