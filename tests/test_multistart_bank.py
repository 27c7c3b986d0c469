"""Bank-scale multistart (solver/multistart_bank.py): basin escape routed
through the bank engines, selection semantics, and the adversarial saddle
bank where single-start solves demonstrably fail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import (
    SolverSettings,
    adversarial_saddle_bank,
    make_bank_multistart_solver,
    make_point_stabilization,
)

PARAMS = Params()
FAST = SolverSettings(barrier_stages=6, iters_per_stage=4, n_alphas=8)


def test_bank_multistart_matches_per_scenario_multistart():
    """The bank-reshaped polish must reproduce the per-scenario multistart
    engine (make_multistart_solver without MPPI) scenario for scenario —
    same seeds, same (converged, cost) selection."""
    from ros2_mpc_jax.solver import make_multistart_solver

    prob = make_point_stabilization(PARAMS, horizon=12, settings=FAST, reference_parity=False)
    B = 16
    thetas, U0 = adversarial_saddle_bank(prob, B, seed=3)
    bank_ms = jax.jit(make_bank_multistart_solver(prob.ocp, FAST, engine="vmap"))
    per_ms = jax.jit(
        jax.vmap(
            make_multistart_solver(prob.ocp, FAST, include_mppi=False),
            in_axes=(0, 0, 0),
        )
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)  # unused without MPPI
    got = bank_ms(thetas, U0)
    ref = per_ms(thetas, U0, keys)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.converged), np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=1e-5)


def test_bank_multistart_uplift_on_saddle_bank():
    """On the adversarial saddle bank the multistart must converge
    scenarios the single-start engine fails — the fleet-scale escape gate.
    (N=40 so the ~1 m goal is reachable and the saddle binds; bench.py
    measures the effect at B=4096, this CPU test pins it at B=32.)"""
    # full default schedule: the obstacle cliffs need the whole barrier
    # continuation (the short FAST schedule fails both engines equally)
    prob = make_point_stabilization(PARAMS, horizon=40, reference_parity=False)
    B = 32
    thetas, U0 = adversarial_saddle_bank(prob, B, seed=0)
    plain = jax.jit(jax.vmap(prob.solve))
    sp = plain(thetas, U0)
    ms = jax.jit(
        make_bank_multistart_solver(prob.ocp, prob.settings, swing_fracs=(1.0,), engine="vmap")
    )
    sm = ms(thetas, U0)
    conv_p = float(jnp.mean(sp.converged.astype(jnp.float32)))
    conv_m = float(jnp.mean(sm.converged.astype(jnp.float32)))
    assert conv_p < 0.95, "saddle bank too easy to demonstrate the failure"
    assert conv_m >= conv_p + 0.05
    # never worse anywhere: the warm start is one of the polished candidates
    cost_p = np.where(np.isnan(np.asarray(sp.cost)), np.inf, np.asarray(sp.cost))
    assert np.all(np.asarray(sm.cost) <= cost_p + 1e-4)


def test_bank_multistart_fast_engine_matches_vmap():
    prob = make_point_stabilization(PARAMS, horizon=8, settings=FAST, reference_parity=False)
    B = 16
    thetas, U0 = adversarial_saddle_bank(prob, B, seed=5)
    got = jax.jit(
        make_bank_multistart_solver(prob.ocp, FAST, engine="fast", lanes=16)
    )(thetas, U0)
    ref = jax.jit(make_bank_multistart_solver(prob.ocp, FAST, engine="vmap"))(thetas, U0)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-4)


def test_multistart_rescue_composite_never_worse_and_rescues():
    """The composed robustness mode (multistart first pass + compacted
    long-schedule multistart rescue, solver/rescue.py): row-wise KKT
    residuals never regress vs plain multistart, and the converged
    fraction moves toward 1 on the saddle bank (round-4 verdict item 2)."""
    from ros2_mpc_jax.solver import make_multistart_two_pass_solver

    prob = make_point_stabilization(PARAMS, horizon=40, reference_parity=False)
    B = 32
    thetas, U0 = adversarial_saddle_bank(prob, B, seed=0)
    ms = jax.jit(
        make_bank_multistart_solver(
            prob.ocp, prob.settings, swing_fracs=(1.0,), engine="vmap"
        )
    )
    comp = jax.jit(
        make_multistart_two_pass_solver(
            prob.ocp, prob.settings, capacity=8, swing_fracs=(1.0,), engine="vmap"
        )
    )
    sm = ms(thetas, U0)
    sc = comp(thetas, U0)
    # the composite's first pass IS the plain multistart program, and the
    # rescue merge only accepts KKT improvements — so row-wise never worse
    assert np.all(np.asarray(sc.kkt_residual) <= np.asarray(sm.kkt_residual) + 1e-6)
    conv_m = float(jnp.mean(sm.converged.astype(jnp.float32)))
    conv_c = float(jnp.mean(sc.converged.astype(jnp.float32)))
    assert conv_c >= conv_m
    assert np.all(np.isfinite(np.asarray(sc.U)))


def test_multistart_rescue_unfused_matches_fused():
    """fuse=False runs the same three stages as separately jitted programs
    (the fallback for compile environments that cannot hold the fused
    module); numerics must be identical."""
    from ros2_mpc_jax.solver import make_multistart_two_pass_solver

    prob = make_point_stabilization(PARAMS, horizon=12, settings=FAST, reference_parity=False)
    B = 32
    thetas, U0 = adversarial_saddle_bank(prob, B, seed=1)
    kw = dict(capacity=4, swing_fracs=(1.0,), engine="vmap", polish_iters=3)
    fused = jax.jit(make_multistart_two_pass_solver(prob.ocp, FAST, **kw))
    unfused = make_multistart_two_pass_solver(prob.ocp, FAST, fuse=False, **kw)
    sf = fused(thetas, U0)
    su = unfused(thetas, U0)
    np.testing.assert_allclose(np.asarray(su.U), np.asarray(sf.U), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(su.converged), np.asarray(sf.converged))


def test_bank_multistart_rejects_unknown_engine():
    prob = make_point_stabilization(PARAMS, horizon=8, settings=FAST)
    with pytest.raises(ValueError, match="unknown engine"):
        make_bank_multistart_solver(prob.ocp, FAST, engine="nope")
