"""Two-pass straggler rescue (solver/rescue.py): compaction, seed best-of,
and scatter-back semantics, engine-agnostic on CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import (
    SolverSettings,
    make_point_stabilization,
    make_two_pass_solver,
)
from ros2_mpc_jax.solver.ilqr import make_solver

PARAMS = Params()
N = 10
WEAK = SolverSettings(barrier_stages=2, iters_per_stage=2, n_alphas=4)
STRONG = SolverSettings(barrier_stages=8, iters_per_stage=6, n_alphas=10)


def _obstacle_bank(B, seed=0):
    prob = make_point_stabilization(PARAMS, horizon=N, reference_parity=False)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.2, 1.2, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    n_obs = PARAMS.n_obstacle_points
    ox = np.full((B, n_obs), 100.0)
    oy = np.full((B, n_obs), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    ox[:, 0] = mid[:, 0] + rng.uniform(-0.2, 0.2, size=B)
    oy[:, 0] = mid[:, 1] + rng.uniform(-0.2, 0.2, size=B)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(goal), jnp.asarray(ox), jnp.asarray(oy)
    )
    return prob, thetas, jnp.zeros((B, N, 2))


def test_two_pass_improves_convergence_and_preserves_converged_rows():
    """A weak first pass leaves stragglers; the two-pass must (a) strictly
    improve the converged fraction, (b) never touch rows the first pass
    already converged, and (c) never make any row's KKT residual worse."""
    prob, thetas, U0 = _obstacle_bank(B=64, seed=1)
    first = jax.vmap(make_solver(prob.ocp, WEAK))
    rescue = jax.vmap(make_solver(prob.ocp, STRONG))
    two_pass = jax.jit(make_two_pass_solver(first, rescue, capacity=16))

    sols1 = jax.jit(first)(thetas, U0)
    sols2 = two_pass(thetas, U0)
    conv1 = np.asarray(sols1.converged)
    conv2 = np.asarray(sols2.converged)
    assert conv1.mean() < 1.0, "bank too easy to exercise the rescue"
    assert conv2.mean() > conv1.mean()
    # converged first-pass rows are bit-identical
    np.testing.assert_array_equal(
        np.asarray(sols2.U)[conv1], np.asarray(sols1.U)[conv1]
    )
    # no row regresses
    assert np.all(
        np.asarray(sols2.kkt_residual) <= np.asarray(sols1.kkt_residual) + 1e-7
    )


def test_two_pass_capacity_overflow_keeps_first_pass_iterates():
    """With more stragglers than capacity, the lowest-indexed ones are
    rescued and the overflow keeps its first-pass solution (no garbage)."""
    prob, thetas, U0 = _obstacle_bank(B=64, seed=2)
    first = jax.vmap(make_solver(prob.ocp, WEAK))
    rescue = jax.vmap(make_solver(prob.ocp, STRONG))
    cap = 4
    two_pass = jax.jit(make_two_pass_solver(first, rescue, capacity=cap))
    sols1 = jax.jit(first)(thetas, U0)
    sols2 = two_pass(thetas, U0)
    fail_idx = np.where(~np.asarray(sols1.converged))[0]
    assert len(fail_idx) > cap, "bank too easy for the overflow test"
    overflow = fail_idx[cap:]
    np.testing.assert_array_equal(
        np.asarray(sols2.U)[overflow], np.asarray(sols1.U)[overflow]
    )
    assert np.all(np.isfinite(np.asarray(sols2.U)))


def test_two_pass_pallas_interpret_smoke():
    """The fused Pallas/Pallas two-pass compiles and improves convergence in
    interpreter mode (the GPU path's exact program, tiny tiles)."""
    from ros2_mpc_jax.solver import make_pallas_two_pass_point_stab

    prob, thetas, U0 = _obstacle_bank(B=32, seed=3)
    tp = jax.jit(
        make_pallas_two_pass_point_stab(
            prob.ocp,
            WEAK,
            capacity=8,
            rescue_settings=STRONG,
            interpret=True,
            tile_s=2,
            tile_l=8,
        )
    )
    sols2 = tp(thetas, U0)
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_point_stab_solver

    sols1 = make_pallas_point_stab_solver(
        prob.ocp, WEAK, interpret=True, tile_s=2, tile_l=8
    )(thetas, U0)
    assert float(jnp.mean(sols2.converged.astype(jnp.float32))) >= float(
        jnp.mean(sols1.converged.astype(jnp.float32))
    )
    assert np.all(np.isfinite(np.asarray(sols2.U)))


def test_two_pass_tracking_interpret_smoke():
    """The tracking twin (Pallas tracking first pass + rescue, one jit)
    improves convergence on an obstacle-active tracking bank."""
    from ros2_mpc_jax.solver import make_pallas_two_pass_tracking, make_tracking
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_tracking_solver

    prob = make_tracking(PARAMS, horizon=N, reference_parity=False)
    B = 32
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack(
        [x0[:, 0:1] + 0.15 * ts[None], np.zeros((B, N)), np.zeros((B, N))], axis=2
    )
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    n_obs = PARAMS.n_obstacle_points
    ox = np.full((B, n_obs), 100.0)
    oy = np.full((B, n_obs), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 0] = rng.uniform(-0.1, 0.1, size=B)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref),
        jnp.asarray(ox), jnp.asarray(oy),
    )
    U0 = jnp.zeros((B, N, 2))
    tp = jax.jit(
        make_pallas_two_pass_tracking(
            prob.ocp, WEAK, capacity=8, rescue_settings=STRONG,
            interpret=True, tile_s=2, tile_l=8,
        )
    )
    sols2 = tp(thetas, U0)
    sols1 = make_pallas_tracking_solver(
        prob.ocp, WEAK, interpret=True, tile_s=2, tile_l=8
    )(thetas, U0)
    assert float(jnp.mean(sols2.converged.astype(jnp.float32))) >= float(
        jnp.mean(sols1.converged.astype(jnp.float32))
    )
    assert np.all(
        np.asarray(sols2.kkt_residual) <= np.asarray(sols1.kkt_residual) + 1e-6
    )


def test_two_pass_rejects_bad_rescue_tile():
    from ros2_mpc_jax.solver import make_pallas_two_pass_point_stab

    prob, _, _ = _obstacle_bank(B=8, seed=4)
    with pytest.raises(ValueError, match="multiple"):
        make_pallas_two_pass_point_stab(
            prob.ocp, WEAK, capacity=6, tile_l=8
        )


def test_kkt_polish_monotone_and_improves():
    """The box-DDP KKT-descent polish (solver/batched.py): per-row residuals
    are monotone non-increasing by construction, and a weak-schedule bank is
    measurably improved — the f32 last-mile stage of the composite."""
    from ros2_mpc_jax.solver import make_bank_kkt_polish

    prob, thetas, U0 = _obstacle_bank(B=16, seed=3)
    first = jax.jit(jax.vmap(make_solver(prob.ocp, WEAK)))
    sols = first(thetas, U0)
    polish = jax.jit(make_bank_kkt_polish(prob.ocp, n_iters=8, lanes=16))
    psols = polish(thetas, sols.U)
    k0 = np.asarray(sols.kkt_residual)
    k1 = np.asarray(psols.kkt_residual)
    assert np.all(k1 <= k0 + 1e-7), "polish must never worsen a row"
    assert k1.mean() < 0.5 * k0.mean(), (k0.mean(), k1.mean())
    assert np.asarray(psols.converged).mean() >= np.asarray(sols.converged).mean()
    assert np.all(np.isfinite(np.asarray(psols.U)))


def test_multistart_rescue_mesh_engine():
    """The composed robustness mode is on the mesh menu: per-shard
    multistart first pass + rescue + polish, sharded over the 8-device
    virtual mesh."""
    from ros2_mpc_jax.parallel import make_bank_solver, make_mesh, shard_bank

    prob, thetas, U0 = _obstacle_bank(B=32, seed=4)
    mesh = make_mesh()
    step = make_bank_solver(
        prob,
        mesh,
        engine="multistart_rescue",
        inner_engine="vmap",
        capacity=2,
        swing_fracs=(1.0,),
        rescue_settings=STRONG,
        polish_iters=4,
    )
    sols, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert np.all(np.isfinite(np.asarray(sols.U)))
    assert np.isfinite(float(metrics["mean_cost"]))
    assert float(metrics["frac_converged"]) > 0.8
