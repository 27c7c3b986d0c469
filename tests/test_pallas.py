"""Whole-solver Pallas kernels vs the XLA engines (interpret mode on CPU), and
their compiled route: cross-lowered for CUDA through Triton at bench shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization
from ros2_mpc_jax.solver.pallas_kernel import make_pallas_point_stab_solver

PARAMS = Params()
N = 10
FAST = SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)


def _bank(prob, B, seed=0, with_obstacles=False):
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3)))
    goals = jnp.asarray(rng.uniform(-1.2, 1.2, size=(B, 3)))
    if with_obstacles:
        n_obs = PARAMS.n_obstacle_points
        ox = np.full((B, n_obs), 100.0)
        oy = np.full((B, n_obs), 100.0)
        ox[:, 0] = rng.uniform(0.3, 0.7, size=B)
        oy[:, 0] = rng.uniform(-0.2, 0.2, size=B)
        thetas = jax.vmap(prob.make_theta)(x0s, goals, jnp.asarray(ox), jnp.asarray(oy))
    else:
        thetas = jax.vmap(prob.make_theta)(x0s, goals)
    return thetas, jnp.zeros((B, N, 2))


def test_pallas_kernel_matches_reference_engine():
    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    B = 16
    thetas, U0 = _bank(prob, B)
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    solve_pl = make_pallas_point_stab_solver(
        prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8
    )
    got = solve_pl(thetas, U0)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.X), np.asarray(ref.X), atol=1e-4)
    # KKT residual should certify the same convergence picture
    assert np.mean(np.asarray(got.converged)) >= np.mean(np.asarray(ref.converged)) - 0.2


def test_pallas_kernel_with_active_obstacles():
    """Corrected-mode point stabilization (live Gaussian obstacle cost)."""
    prob = make_point_stabilization(
        PARAMS, horizon=N, settings=FAST, reference_parity=False
    )
    B = 16
    thetas, U0 = _bank(prob, B, seed=1, with_obstacles=True)
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    solve_pl = make_pallas_point_stab_solver(
        prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8
    )
    got = solve_pl(thetas, U0)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-3)


def test_pallas_tracking_kernel_matches_reference():
    from ros2_mpc_jax.solver import make_tracking
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_tracking_solver

    prob = make_tracking(PARAMS, horizon=N, settings=FAST, reference_parity=False)
    B = 16
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack(
        [x0[:, 0:1] + 0.15 * ts[None], np.zeros((B, N)), np.zeros((B, N))], axis=2
    )
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    n_obs = PARAMS.n_obstacle_points
    ox = np.full((B, n_obs), 100.0)
    oy = np.full((B, n_obs), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)  # one live obstacle near the line
    oy[:, 0] = rng.uniform(-0.15, 0.15, size=B)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref),
        jnp.asarray(ox), jnp.asarray(oy),
    )
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    got = make_pallas_tracking_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas, U0
    )
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-3)


def test_pallas_tracking_kernel_terminal_weight():
    """The corrected parking mode (nonzero terminal pose weight,
    solver/problems.py::make_tracking terminal_weight) must run on the
    Pallas tracking kernel and match the vmap engine — and the weight must
    actually bend the solution (vs the parity zero-weight solve)."""
    from ros2_mpc_jax.solver import make_tracking
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_tracking_solver

    B = 16
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack(
        [
            x0[:, 0:1] + 0.15 * ts[None],
            np.zeros((B, N)),
            np.full((B, N), 0.9),  # misaligned reference yaw: the stage
        ],  # Q[2]=0.005 barely pays for the turn; the terminal weight must
        axis=2,  # (ROADMAP goal-orbiting fix)
    )
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    tw = (2.0, 2.0, 1.0)
    prob = make_tracking(
        PARAMS, horizon=N, settings=FAST, reference_parity=False, terminal_weight=tw
    )
    prob0 = make_tracking(PARAMS, horizon=N, settings=FAST, reference_parity=False)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref)
    )
    thetas0 = jax.vmap(prob0.make_theta)(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref)
    )
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    solve_pl = make_pallas_tracking_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8)
    got = solve_pl(thetas, U0)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-3)
    # same kernel build, zero weights in theta -> the parity solution
    got0 = solve_pl(thetas0, U0)
    ref0 = jax.jit(jax.vmap(prob0.solve))(thetas0, U0)
    np.testing.assert_allclose(np.asarray(got0.U), np.asarray(ref0.U), atol=5e-4)
    # the terminal weight must do real work: final yaw pulled toward 0.9
    yaw_err = np.abs(np.asarray(got.X)[:, -1, 2] - 0.9)
    yaw_err0 = np.abs(np.asarray(got0.X)[:, -1, 2] - 0.9)
    assert np.mean(yaw_err) < np.mean(yaw_err0) - 0.1


def test_fast_sincos_accuracy_and_kernel_parity():
    """The kernels' paired-polynomial sin/cos must stay within a few 1e-6 of
    numpy over the whole plausible angle range (un-wrapped fleet rollouts
    reach tens of radians), and the kernel built on it must agree with the
    vmap engine (stock jnp.sin/jnp.cos) within the engines' parity band on
    headings that span several turns."""
    from ros2_mpc_jax.solver.pallas_kernel import _fast_sincos

    x = jnp.asarray(np.linspace(-60.0, 60.0, 400001), dtype=jnp.float32)
    c, s = jax.jit(_fast_sincos)(x)
    x64 = np.asarray(x, dtype=np.float64)
    assert float(jnp.max(jnp.abs(c - np.cos(x64)))) < 5e-6
    assert float(jnp.max(jnp.abs(s - np.sin(x64)))) < 5e-6

    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    B = 16
    rng = np.random.default_rng(9)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    x0[:, 2] += 2.0 * np.pi * rng.integers(-5, 6, size=B)  # wound-up headings
    goal = rng.uniform(-1.2, 1.2, size=(B, 3))
    goal[:, 2] += x0[:, 2] - x0[:, 2] % (2.0 * np.pi)
    thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    got = make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas, U0
    )
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=1e-3)


def test_pallas_kernel_live_prefix_chunking_edges():
    """The chunked obstacle loop must be exact at its edge cases: a live
    obstacle in the *last* slot (n_live = n_obs, full loop), obstacles
    straddling chunk boundaries, and an all-sentinel bank (n_live = 0 with a
    nonzero weight — corrected mode on open floor)."""
    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST, reference_parity=False)
    B = 16
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3)))
    goals = jnp.asarray(rng.uniform(-1.2, 1.2, size=(B, 3)))
    n_obs = PARAMS.n_obstacle_points
    ox = np.full((B, n_obs), 100.0)
    oy = np.full((B, n_obs), 100.0)
    # chunk-boundary straddle (indices 7, 8) and a live point in the LAST slot
    ox[:, 7] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 7] = rng.uniform(-0.2, 0.2, size=B)
    ox[:, 8] = rng.uniform(-0.6, -0.3, size=B)
    oy[:, 8] = rng.uniform(-0.2, 0.2, size=B)
    ox[:, n_obs - 1] = rng.uniform(0.2, 0.5, size=B)
    oy[:, n_obs - 1] = rng.uniform(0.2, 0.5, size=B)
    thetas = jax.vmap(prob.make_theta)(x0s, goals, jnp.asarray(ox), jnp.asarray(oy))
    U0 = jnp.zeros((B, N, 2))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    got = make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas, U0
    )
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U), atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=2e-4)

    # all-sentinel with nonzero weight: n_live == 0 short-circuits to the
    # obstacle-free solution exactly
    ox[:] = 100.0
    oy[:] = 100.0
    thetas0 = jax.vmap(prob.make_theta)(x0s, goals, jnp.asarray(ox), jnp.asarray(oy))
    ref0 = jax.jit(jax.vmap(prob.solve))(thetas0, U0)
    got0 = make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas0, U0
    )
    np.testing.assert_allclose(np.asarray(got0.U), np.asarray(ref0.U), atol=2e-4)


@pytest.mark.parametrize("kind, horizon", [("point", 20), ("point", 40), ("tracking", 20), ("tracking", 40)])
def test_kernels_cross_lower_for_cuda_at_bench_shapes(kind, horizon):
    """Compiled route, checked without a card: both kernels lower for CUDA
    through Triton at the bench shapes (B=4096, 160 obstacle points, the
    default block). The interpreter enforces none of the Triton backend's
    rules (no scratch memory, no scalar prefetch, power-of-two loads and
    stores); this lowering does."""
    from ros2_mpc_jax.solver import make_tracking
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_tracking_solver

    B = 4096
    if kind == "point":
        prob = make_point_stabilization(PARAMS, horizon=horizon, reference_parity=False)
        thetas = jax.vmap(prob.make_theta)(jnp.zeros((B, 3)), jnp.ones((B, 3)))
        maker = make_pallas_point_stab_solver
    else:
        prob = make_tracking(
            PARAMS, horizon=horizon, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0)
        )
        thetas = jax.vmap(prob.make_theta)(
            jnp.zeros((B, 3)), jnp.zeros((B, horizon, 3)), jnp.zeros((B, horizon, 2))
        )
        maker = make_pallas_tracking_solver
    assert thetas["obs_x"].shape == (B, 160)
    solve = maker(prob.ocp, prob.settings, interpret=False)
    text = (
        jax.jit(solve)
        .trace(thetas, jnp.zeros((B, horizon, 2)))
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert "__gpu$xla.gpu.triton" in text
    assert ("tracking_solver" if kind == "tracking" else "point_stab_solver") in text


@pytest.mark.parametrize("backend, interpret", [("cpu", True), ("gpu", False)])
def test_pallas_interpret_platform_rule(backend, interpret):
    from ros2_mpc_jax.solver.pallas_kernel import pallas_interpret

    assert pallas_interpret(backend) is interpret
    assert pallas_interpret() is True  # the tests run on the CPU backend


def test_pallas_interpret_rejects_other_backends():
    from ros2_mpc_jax.solver.pallas_kernel import pallas_interpret

    with pytest.raises(RuntimeError, match="no Pallas route"):
        pallas_interpret("rocm")


def test_kernel_tile_and_bank_checks():
    """Blocks are powers of two; compiled rows are whole warps (no scenario
    replicated across threads); the bank is a whole number of blocks."""
    prob = make_point_stabilization(PARAMS, horizon=N, settings=FAST)
    with pytest.raises(ValueError, match="power of two"):
        make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=3, tile_l=8)
    with pytest.raises(ValueError, match="multiple of 32"):
        make_pallas_point_stab_solver(prob.ocp, FAST, interpret=False, tile_s=2, tile_l=16)
    make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=2, tile_l=16)
    thetas, U0 = _bank(prob, 24)
    solve = make_pallas_point_stab_solver(prob.ocp, FAST, interpret=True, tile_s=1, tile_l=16)
    with pytest.raises(ValueError, match="multiple of the tile"):
        solve(thetas, U0)
