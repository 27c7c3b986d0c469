"""Scaling-path tests: long horizons (the sequence axis), the scaling
benchmark harness, and the sweep CLI table."""

import numpy as np

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.parallel import scaling_bench
from ros2_mpc_jax.solver import SolverSettings, make_tracking

PARAMS = Params()


def test_long_horizon_tracking_N256():
    """The reference unrolls N symbolic shooting constraints and cannot scale
    its horizon (SURVEY.md §5); the lax.scan formulation compiles O(1) in N.
    N=256 (51 s lookahead) must solve and track."""
    import jax

    N = 256
    settings = SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
    prob = make_tracking(PARAMS, horizon=N, settings=settings)
    ts = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack([0.15 * ts, np.zeros(N), np.zeros(N)], axis=1)
    u_ref = np.tile([0.15, 0.0], (N, 1))
    theta = prob.make_theta(np.array([0.0, 0.0, 0.0]), x_ref, u_ref)
    sol = jax.jit(prob.solve)(theta, prob.default_u0)
    U = np.asarray(sol.U)
    assert np.all(np.isfinite(U))
    # cruises at the (bounded) reference velocity through the horizon interior
    assert np.all(U[5:-5, 0] > 0.12)
    # terminal state roughly at the end of the reference line
    assert abs(float(sol.X[-1, 0]) - 0.15 * N * PARAMS.dt) < 1.5


def test_scaling_bench_harness():
    """Floor assertion on the virtual CPU mesh. The measurable ceiling here
    is far below 1.0 by construction: the 1-device baseline already uses both
    physical cores via XLA's intra-op threadpool, while the 8-virtual-device
    run adds per-device dispatch/sync on the same two cores (measured
    ~0.33 at this size, ~0.2-0.4 across engines/batches). The floor guards
    against partitioning regressions (resharding, accidental replication)
    that would tank it to ~1/8; the real >= 80% BASELINE target applies to
    real multi-chip hardware, recorded via scaling_bench.main() artifacts."""
    out = scaling_bench.run(per_device_batch=16, horizon=6, reps=2)
    assert out["devices"] == 8
    assert out["solves_per_s_1dev"] > 0
    assert out["solves_per_s_ndev"] > 0
    # Floor: a partitioning catastrophe (accidental replication, per-device
    # resharding) measures ~1/8 = 0.125 here. Healthy runs measure 0.2-0.4
    # depending on ambient host load, so the floor sits between the two
    # regimes rather than inside the healthy band (0.25 flaked under a
    # loaded full-suite run).
    assert 0.17 <= out["scaling_efficiency"] <= 1.6, out


def test_scaling_bench_all_engines(tmp_path):
    """All engines run through the harness; artifact schema stable."""
    import json

    out = scaling_bench.run_all_engines(per_device_batch=8, horizon=5, reps=1)
    engines = {r["engine"] for r in out["results"]}
    assert engines == {
        "vmap", "fast", "pallas", "mppi",
        "two_pass", "multistart_bank", "multistart_rescue",
    }
    assert 0.0 < out["contention_ceiling"] <= 1.0
    for r in out["results"]:
        assert r["solves_per_s_ndev"] > 0, r
        assert 0.0 < r["scaling_efficiency"] <= 2.0, r
        assert 0.0 < r["efficiency_vs_ceiling"] <= 1.0, r
    # artifact round-trips as JSON
    p = tmp_path / "scaling.json"
    p.write_text(json.dumps(out))
    assert json.loads(p.read_text())["devices"] == 8


def test_sweep_cli_prints_table(capsys):
    from ros2_mpc_jax.parallel.sweep import SweepSpec, run_sweep
    from ros2_mpc_jax.solver import make_point_stabilization

    prob = make_point_stabilization(
        PARAMS, horizon=5, settings=SolverSettings(barrier_stages=2, iters_per_stage=2, n_alphas=4)
    )
    out = run_sweep(prob, SweepSpec(q_scales=(1.0,), r_scales=(0.5, 1.0), scenarios_per_config=8))
    assert out["mean_goal_error"].shape == (2,)
    assert np.all(np.isfinite(out["mean_goal_error"]))


def test_fleet_closed_loop_reaches_goals():
    """Whole fleet closed loop under one jit: most open-floor scenarios must
    reach their goals within the tick budget."""

    from ros2_mpc_jax.parallel.fleet import make_fleet_rollout, random_fleet
    from ros2_mpc_jax.solver import make_point_stabilization

    # horizon >= 20 (4 s lookahead): shorter horizons park at a standoff
    # where within-horizon turn gains vanish (same effect the follower's
    # goal handoff addresses)
    prob = make_point_stabilization(
        PARAMS, horizon=20,
        settings=SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6),
    )
    thetas, U0 = random_fleet(prob, B=16, seed=0, spread=0.8)
    rollout = make_fleet_rollout(prob, n_ticks=120, dt=PARAMS.dt, record=True)
    out = rollout(thetas, U0)
    assert out.final_states.shape == (16, 3)
    assert out.trajectories.shape == (121, 16, 3)
    assert float(out.reach_fraction) >= 0.9, f"only {float(out.reach_fraction):.2f} reached"
    assert np.all(np.isfinite(np.asarray(out.trajectories)))


def test_sweep_engine_option_matches_vmap():
    """run_sweep engine='pallas' (interpreted on the CPU) must reproduce the vmap
    sweep's per-config quality (same thetas, same algorithm)."""
    from ros2_mpc_jax.parallel.sweep import SweepSpec, run_sweep
    from ros2_mpc_jax.solver import make_point_stabilization

    settings = SolverSettings(barrier_stages=2, iters_per_stage=2, n_alphas=4)
    prob = make_point_stabilization(PARAMS, horizon=5, settings=settings)
    spec = SweepSpec(q_scales=(0.5, 1.0), r_scales=(1.0,), scenarios_per_config=512)
    out_v = run_sweep(prob, spec, engine="vmap")
    # 2 configs x 512 = 1024 scenarios over the 8-device mesh -> 128 per
    # shard: one (1, 128) block
    out_p = run_sweep(prob, spec, engine="pallas", tile_s=1, tile_l=128)
    np.testing.assert_allclose(
        out_p["mean_goal_error"], out_v["mean_goal_error"], atol=2e-4
    )
