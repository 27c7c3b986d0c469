"""Multi-device tests on the virtual 8-device CPU mesh: sharded bank solves
must agree with unsharded vmap, metrics must reduce across the mesh, sweeps
must checkpoint/resume, and the driver's dryrun must pass."""

import jax
import jax.numpy as jnp
import numpy as np

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.parallel import (
    SweepSpec,
    make_bank_solver,
    make_host_chip_mesh,
    make_mesh,
    run_sweep,
    shard_bank,
)
from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization

PARAMS = Params()
FAST = SolverSettings(barrier_stages=3, iters_per_stage=3, n_alphas=6)


def _problem(horizon=8):
    return make_point_stabilization(PARAMS, horizon=horizon, settings=FAST)


def _bank(problem, B, seed=0):
    rng = np.random.default_rng(seed)
    thetas = jax.vmap(problem.make_theta)(
        jnp.asarray(rng.uniform(-0.2, 0.2, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3))),
    )
    U0 = jnp.zeros((B,) + problem.default_u0.shape)
    return thetas, U0


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8, "conftest must force an 8-device CPU mesh"


def test_sharded_bank_matches_unsharded():
    prob = _problem()
    B = 16
    thetas, U0 = _bank(prob, B)
    mesh = make_mesh()
    step = make_bank_solver(prob, mesh)
    sols_sharded, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_plain = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    np.testing.assert_allclose(
        np.asarray(sols_sharded.U), np.asarray(sols_plain.U), atol=1e-5
    )
    assert np.isfinite(float(metrics["mean_cost"]))
    assert 0.0 <= float(metrics["frac_converged"]) <= 1.0
    # solution actually sharded over the mesh
    assert len(sols_sharded.U.sharding.device_set) == 8


def test_sharded_fast_engine_matches():
    """The lane-aligned engine, shard_map-wrapped over the 8-device mesh,
    must agree with the vmap engine."""
    prob = _problem(horizon=6)
    B = 256  # 32 scenarios per device
    thetas, U0 = _bank(prob, B, seed=3)
    mesh = make_mesh()
    fast = make_bank_solver(prob, mesh, engine="fast", lanes=32)
    ref = make_bank_solver(prob, mesh, engine="vmap")
    sols_f, met_f = fast(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_r, met_r = ref(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    # identical algorithm, different op order: f32 drift compounds over the
    # iteration schedule on a few of the 256 scenarios
    np.testing.assert_allclose(np.asarray(sols_f.U), np.asarray(sols_r.U), atol=1e-3)
    np.testing.assert_allclose(
        float(met_f["mean_cost"]), float(met_r["mean_cost"]), rtol=1e-4
    )
    assert len(sols_f.U.sharding.device_set) == 8


def test_sharded_pallas_engine_matches():
    """The whole-solver Pallas kernel (interpreter mode on CPU),
    shard_map-wrapped over the 8-device mesh, must agree with vmap."""
    prob = _problem(horizon=6)
    B = 64  # 8 scenarios per device = one (2, 4) tile each
    thetas, U0 = _bank(prob, B, seed=4)
    mesh = make_mesh()
    pal = make_bank_solver(prob, mesh, engine="pallas", tile_s=2, tile_l=4)
    ref = make_bank_solver(prob, mesh, engine="vmap")
    sols_p, met_p = pal(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_r, met_r = ref(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    np.testing.assert_allclose(np.asarray(sols_p.U), np.asarray(sols_r.U), atol=1e-3)
    np.testing.assert_allclose(
        float(met_p["mean_cost"]), float(met_r["mean_cost"]), rtol=1e-4
    )
    assert len(sols_p.U.sharding.device_set) == 8


def test_sharded_pallas_tracking_engine_matches():
    """Sharded tracking Pallas kernel == vmap on the 8-device mesh."""
    from ros2_mpc_jax.solver import make_tracking

    N = 6
    prob = make_tracking(PARAMS, horizon=N, settings=FAST, reference_parity=False)
    B = 32
    rng = np.random.default_rng(7)
    ts = np.arange(1, N + 1) * PARAMS.dt
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    x_ref = np.stack(
        [x0[:, 0:1] + 0.15 * ts[None], np.zeros((B, N)), np.zeros((B, N))], axis=2
    )
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref)
    )
    U0 = jnp.zeros((B, N, 2))
    mesh = make_mesh()
    pal = make_bank_solver(prob, mesh, engine="pallas", tile_s=2, tile_l=2)
    ref = make_bank_solver(prob, mesh, engine="vmap")
    sols_p, _ = pal(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_r, _ = ref(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    np.testing.assert_allclose(np.asarray(sols_p.U), np.asarray(sols_r.U), atol=1e-3)


def test_host_chip_mesh_2d():
    prob = _problem()
    mesh = make_host_chip_mesh(2, 4)
    B = 16
    thetas, U0 = _bank(prob, B, seed=1)
    step = make_bank_solver(prob, mesh, axis_names=("host", "chip"))
    sols, metrics = step(
        shard_bank(thetas, mesh, ("host", "chip")), shard_bank(U0, mesh, ("host", "chip"))
    )
    assert sols.U.shape == (B, 8, 2)
    assert np.isfinite(float(metrics["max_kkt"]))


def test_sweep_checkpoint_resume(tmp_path):
    prob = _problem(horizon=5)
    spec = SweepSpec(q_scales=(0.5, 1.0), r_scales=(1.0,), scenarios_per_config=8, seed=2)
    ck = str(tmp_path / "sweep.npz")
    out1 = run_sweep(prob, spec, mesh=make_mesh(), checkpoint_path=ck, chunk_size=8)
    assert out1["mean_goal_error"].shape == (2,)
    # resume: all chunks cached, result identical
    out2 = run_sweep(prob, spec, mesh=make_mesh(), checkpoint_path=ck, chunk_size=8)
    np.testing.assert_allclose(out1["mean_goal_error"], out2["mean_goal_error"])
    assert tuple(out1["best_config"]) in {(0.5, 1.0), (1.0, 1.0)}


def test_graft_dryrun_multichip():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_graft_entry_compiles():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as graft

    fn, args = graft.entry()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    sol = compiled(*args)
    assert np.all(np.isfinite(np.asarray(sol.U)))


def test_composite_engines_on_mesh():
    """The production composites — two-pass straggler rescue and bank
    multistart — run per-shard on the 8-device mesh and never regress the
    vmap engine's answers (two_pass only improves KKT; multistart_bank
    only improves (converged, cost))."""
    N = 6
    prob = _problem(horizon=N)
    mesh = make_mesh(8)
    B = 8 * 2 * 8
    rng = np.random.default_rng(3)
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.2, 0.2, size=(B, 3))),
        jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3))),
    )
    U0 = jnp.zeros((B, N, 2))
    # baseline: the plain pallas engine (the composites' own first pass /
    # polish numerics — a vmap baseline would differ in the noise floor)
    ref, _ = make_bank_solver(prob, mesh, engine="pallas", tile_s=2, tile_l=8)(
        shard_bank(thetas, mesh), shard_bank(U0, mesh)
    )

    tp_step = make_bank_solver(
        prob, mesh, engine="two_pass",
        capacity=8, tile_s=2, tile_l=8,
    )
    tp, _ = tp_step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert np.all(
        np.asarray(tp.kkt_residual) <= np.asarray(ref.kkt_residual) + 1e-6
    )

    ms_step = make_bank_solver(
        prob, mesh, engine="multistart_bank", swing_fracs=(1.0,),
        tile_s=2, tile_l=8,
    )
    ms, _ = ms_step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    ref_cost = np.where(np.isnan(np.asarray(ref.cost)), np.inf, np.asarray(ref.cost))
    assert np.all(np.asarray(ms.cost) <= ref_cost + 1e-4)


def test_pallas_engine_solves_terminal_cost_problems():
    """Terminal-weight tracking problems (the corrected parking mode) run on
    the sharded Pallas engine and match the vmap engine — the round-3
    engine-generality seam (the kernel used to reject nonzero terminal
    weights) is closed."""
    from ros2_mpc_jax.solver import make_tracking

    N = 5
    prob = make_tracking(Params(), horizon=N, terminal_weight=(10.0, 10.0, 1.0))
    mesh = make_mesh(8)
    rng = np.random.default_rng(11)
    B = 8 * 2 * 8  # per-device multiple of tile_s * tile_l
    x0 = jnp.asarray(rng.uniform(-0.2, 0.2, size=(B, 3)))
    ts = np.arange(1, N + 1) * Params().dt
    x_ref = jnp.asarray(
        np.stack([0.1 * np.tile(ts, (B, 1)), np.zeros((B, N)), np.full((B, N), 0.5)], axis=2)
    )
    u_ref = jnp.asarray(np.tile([0.1, 0.0], (B, N, 1)))
    thetas = jax.vmap(prob.make_theta)(x0, x_ref, u_ref)
    U0 = jnp.zeros((B, N, 2))
    step = make_bank_solver(prob, mesh, engine="pallas", tile_s=2, tile_l=8)
    sols, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    ref = jax.jit(jax.vmap(prob.solve))(thetas, U0)
    np.testing.assert_allclose(np.asarray(sols.U), np.asarray(ref.U), atol=5e-4)


def test_sharded_fleet_rollout_matches_unsharded():
    """The closed-loop fleet evaluator sharded over the 8-device mesh must
    produce the same trajectories and fleet statistics as the single-device
    rollout — robots are independent, so sharding must be exact up to f32
    reduction order."""
    from ros2_mpc_jax.parallel.fleet import (
        make_fleet_rollout,
        make_sharded_fleet_rollout,
        random_fleet,
    )

    prob = _problem(horizon=6)
    B = 32
    thetas, U0 = random_fleet(prob, B, seed=5, spread=0.8)
    n_ticks, dt = 8, PARAMS.dt

    plain = make_fleet_rollout(prob, n_ticks, dt)
    res_plain = plain(thetas, U0)

    mesh = make_mesh()
    sharded = make_sharded_fleet_rollout(prob, mesh, n_ticks, dt)
    res_shard = sharded(shard_bank(thetas, mesh), shard_bank(U0, mesh))

    np.testing.assert_allclose(
        np.asarray(res_shard.final_states), np.asarray(res_plain.final_states), atol=1e-5
    )
    np.testing.assert_allclose(
        float(res_shard.reach_fraction), float(res_plain.reach_fraction), atol=1e-6
    )
    np.testing.assert_allclose(
        float(res_shard.mean_dist), float(res_plain.mean_dist), atol=1e-5
    )
    # the rollout really ran sharded
    assert len(res_shard.final_states.sharding.device_set) == 8


def test_sharded_fleet_rollout_fast_engine_records_trajectories():
    """Sharded fleet with the lane-aligned engine + trajectory recording:
    the (T+1, B, 3) trace shards over the robot axis, and every robot moves."""
    from ros2_mpc_jax.parallel.fleet import make_sharded_fleet_rollout, random_fleet

    prob = _problem(horizon=6)
    B = 64  # 8 per device, lanes=8
    thetas, U0 = random_fleet(prob, B, seed=6, spread=0.8)
    mesh = make_mesh()
    roll = make_sharded_fleet_rollout(
        prob, mesh, n_ticks=6, dt=PARAMS.dt, record=True, engine="fast", lanes=8
    )
    res = roll(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    traj = np.asarray(res.trajectories)
    assert traj.shape == (7, B, 3)
    assert np.all(np.isfinite(traj))
    moved = np.linalg.norm(traj[-1, :, :2] - traj[0, :, :2], axis=-1)
    assert np.all(moved > 1e-4)


def test_fleet_rollout_validates_engine_and_problem():
    """ADVICE r2 regressions: the fleet builders must fail loudly on
    mismatched engine/opts/problem combinations instead of silently solving
    the wrong thing."""
    import pytest

    from ros2_mpc_jax.parallel.fleet import make_fleet_rollout
    from ros2_mpc_jax.solver import make_tracking

    prob = _problem(horizon=6)
    # engine_opts with the default vmap engine: silent no-op before, error now
    with pytest.raises(ValueError, match="vmap"):
        make_fleet_rollout(prob, n_ticks=4, dt=PARAMS.dt, lanes=8)
    # tracking problems have no place in the goal-driven fleet loop
    trk = make_tracking(PARAMS, horizon=6)
    with pytest.raises(ValueError, match="tracking"):
        make_fleet_rollout(trk, n_ticks=4, dt=PARAMS.dt)
    # terminal-cost problems can't run on the parity-structured Pallas kernel
    trk_term = make_tracking(PARAMS, horizon=6, terminal_weight=(1.0, 1.0, 0.5))
    assert "terminal_cost" in trk_term.tags


def test_fleet_rollout_pallas_follows_the_platform_rule():
    """engine='pallas' takes no interpret flag from its callers:
    solver.pallas_kernel.pallas_interpret decides in one place — interpreted
    here on the CPU, compiled on a GPU — so the plain fleet rollout runs the
    kernel and its closed loop matches the vmap engine's."""
    from ros2_mpc_jax.parallel.fleet import make_fleet_rollout, random_fleet

    assert jax.default_backend() == "cpu"
    prob = _problem(horizon=4)
    thetas, U0 = random_fleet(prob, B=8, seed=0)
    pal = make_fleet_rollout(prob, n_ticks=2, dt=PARAMS.dt, engine="pallas", tile_s=1, tile_l=8)
    ref = make_fleet_rollout(prob, n_ticks=2, dt=PARAMS.dt)
    np.testing.assert_allclose(
        np.asarray(pal(thetas, U0).final_states),
        np.asarray(ref(thetas, U0).final_states),
        atol=1e-4,
    )


def test_sharded_mppi_engine():
    """The sampling engine on the 8-device mesh: per-scenario keys are
    derived from the GLOBAL scenario index inside the jit, so the sharded
    result must equal the single-program (unsharded-trace) result exactly,
    independent of the mesh layout."""
    from ros2_mpc_jax.solver.mppi import MppiSettings, make_mppi_solver

    prob = _problem(horizon=6)
    B = 16
    thetas, U0 = _bank(prob, B, seed=9)
    mesh = make_mesh()
    ms = MppiSettings(n_samples=24, n_iters=4)
    step = make_bank_solver(prob, mesh, engine="mppi", seed=3, settings=ms)
    sols, metrics = step(shard_bank(thetas, mesh), shard_bank(U0, mesh))

    # reference: the same key derivation, plain vmap, no mesh
    solve1 = make_mppi_solver(prob.ocp, ms)
    idx = jnp.arange(B, dtype=jnp.uint32)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(3), idx)
    ref = jax.jit(jax.vmap(solve1))(thetas, U0, keys)

    np.testing.assert_allclose(np.asarray(sols.U), np.asarray(ref.U), atol=1e-6)
    assert len(sols.U.sharding.device_set) == 8
    assert np.isfinite(float(metrics["mean_cost"]))
    lo, hi = np.asarray(prob.ocp.u_lo), np.asarray(prob.ocp.u_hi)
    u = np.asarray(sols.U)
    assert (u >= lo - 1e-6).all() and (u <= hi + 1e-6).all()


def test_sharded_hybrid_engine_never_worse_than_vmap():
    """engine='hybrid' on the mesh: converged count and costs must not lose
    to the plain local engine (the hybrid keeps the better of the two)."""
    from ros2_mpc_jax.solver.mppi import MppiSettings

    prob = _problem(horizon=6)
    B = 16
    thetas, U0 = _bank(prob, B, seed=4)
    mesh = make_mesh()
    hyb = make_bank_solver(
        prob, mesh, engine="hybrid", settings=MppiSettings(n_samples=16, n_iters=3)
    )
    ref = make_bank_solver(prob, mesh, engine="vmap")
    sols_h, met_h = hyb(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_v, met_v = ref(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert float(met_h["frac_converged"]) >= float(met_v["frac_converged"]) - 1e-6
    both = np.asarray(sols_h.converged) & np.asarray(sols_v.converged)
    assert (
        np.asarray(sols_h.cost)[both] <= np.asarray(sols_v.cost)[both] + 1e-5
    ).all()


def test_bank_solver_rejects_unknown_engine_and_stray_opts():
    import pytest as _pytest

    prob = _problem(horizon=4)
    mesh = make_mesh(1)
    with _pytest.raises(ValueError, match="unknown engine"):
        make_bank_solver(prob, mesh, engine="sqp")
    with _pytest.raises(ValueError, match="no engine_opts"):
        make_bank_solver(prob, mesh, engine="vmap", lanes=8)
    with _pytest.raises(ValueError, match="seed=/settings="):
        make_bank_solver(prob, mesh, engine="mppi", lanes=8)


def test_sharded_multistart_engine():
    """engine='multistart' on the mesh: converged fraction and costs must
    not lose to the plain vmap engine (the warm start is one candidate)."""
    from ros2_mpc_jax.solver.mppi import MppiSettings

    prob = _problem(horizon=6)
    B = 16
    thetas, U0 = _bank(prob, B, seed=12)
    mesh = make_mesh()
    ms = make_bank_solver(
        prob, mesh, engine="multistart",
        settings=MppiSettings(n_samples=16, n_iters=2),
    )
    ref = make_bank_solver(prob, mesh, engine="vmap")
    sols_m, met_m = ms(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    sols_v, met_v = ref(shard_bank(thetas, mesh), shard_bank(U0, mesh))
    assert float(met_m["frac_converged"]) >= float(met_v["frac_converged"]) - 1e-6
    both = np.asarray(sols_m.converged) & np.asarray(sols_v.converged)
    assert (np.asarray(sols_m.cost)[both] <= np.asarray(sols_v.cost)[both] + 1e-5).all()
    assert len(sols_m.U.sharding.device_set) == 8
