"""Headline benchmark: batched N=20 unicycle NMPC solves/s on one GPU.

BASELINE.json target: >= 1000 solves/s per device (the reference's
CasADi/IPOPT stack solves one ~N=30 NLP per 0.2 s tick on CPU, i.e. ~5/s).
Prints exactly one JSON line on stdout:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "device": ..., "secondary": {...}}

Extra detail (latency percentiles, batch size) goes to stderr. Needs a GPU:
on any other backend it fails instead of measuring something else. A
secondary cell that fails prints why on stderr, and the script then exits
non-zero after printing what the other cells measured.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

TARGET_SOLVES_PER_S = 1000.0  # BASELINE.json north-star
N_HORIZON = 20
BATCH = 4096  # BASELINE.json config 4: 4096-scenario bank per device


def _stream_rate(solve, args, k: int, rounds: int = 2) -> float:
    """Seconds per call over ``k`` pipelined dispatches, best of ``rounds``."""
    import jax

    best = np.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready([solve(*args) for _ in range(k)])
        best = min(best, time.perf_counter() - t0)
    return best / k


def _frac(mask) -> float:
    return round(float(np.mean(np.asarray(mask))), 4)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from ros2_mpc_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.solver import (
        SolverSettings,
        make_point_stabilization,
        make_tracking,
        shift_controls,
    )
    from ros2_mpc_jax.solver.banks import point_stab_banks, tracking_bank
    from ros2_mpc_jax.solver.pallas_kernel import (
        make_pallas_point_stab_solver,
        make_pallas_tracking_solver,
    )

    params = Params()
    prob = make_point_stabilization(params, horizon=N_HORIZON)
    prob_c = make_point_stabilization(params, horizon=N_HORIZON, reference_parity=False)
    bank = point_stab_banks(prob, prob_c, BATCH, seed=0)
    thetas, thetas_c, U0 = bank["thetas"], bank["thetas_c"], bank["U0"]

    # Headline: the whole-solver kernel on the inert bank. Two regimes:
    # * single dispatch: one blocking solve of the 4096 bank, host dispatch
    #   included;
    # * sustained: K calls issued back-to-back, blocked once — the dispatch
    #   pipeline overlaps compute, measuring steady-state device throughput
    #   (what one big bank or a production request stream sees).
    solve = jax.jit(make_pallas_point_stab_solver(prob.ocp, prob.settings))
    sols = jax.block_until_ready(solve(thetas, U0))
    single_dispatch_s = _stream_rate(solve, (thetas, U0), k=1, rounds=5)
    K = 16
    solves_per_s = BATCH / _stream_rate(solve, (thetas, U0), k=K, rounds=3)
    frac_conv = _frac(sols.converged)

    # Real-time tick latency: one solve alone on the device (BASELINE budget
    # 0.2 s/tick). Cold: zero warm start, full schedule. Warm: the production
    # tick path — shifted previous solution + realtime schedule
    # (SolverSettings.realtime, as the follower nodes run).
    single = jax.jit(jax.vmap(prob.solve))
    theta1 = jax.tree_util.tree_map(lambda l: l[:1], thetas)
    sol1 = jax.block_until_ready(single(theta1, U0[:1]))
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(single(theta1, U0[:1]))
        lat.append(time.perf_counter() - t0)
    prob_rt = make_point_stabilization(
        params, horizon=N_HORIZON, settings=SolverSettings.realtime()
    )
    single_rt = jax.jit(jax.vmap(prob_rt.solve))
    U_warm = jax.vmap(shift_controls)(sol1.U)
    jax.block_until_ready(single_rt(theta1, U_warm))
    lat_w = []
    for _ in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(single_rt(theta1, U_warm))
        lat_w.append(time.perf_counter() - t0)

    secondary = {}
    failed = []

    def cell(fn):
        """Run one secondary cell; a failure is reported, never hidden."""
        try:
            fn()
        except Exception:  # noqa: BLE001 — printed below, and the exit code says so
            failed.append(fn.__name__)
            print(f"bench cell {fn.__name__} FAILED:\n{traceback.format_exc()}", file=sys.stderr)
        return fn

    @cell
    def corrected():
        # obstacle-active mode: same compiled bank program (the obstacle
        # weight/gain are runtime theta values)
        sols_c = jax.block_until_ready(solve(thetas_c, U0))
        secondary["corrected_obstacle_solves_per_s"] = round(
            BATCH / _stream_rate(solve, (thetas_c, U0), k=8), 1
        )
        secondary["corrected_obstacle_converged_frac"] = _frac(sols_c.converged)
        # the strict flag is KKT < 1e-4; on the exponential obstacle cliffs
        # f32 gradient noise parks a few % at 1e-4..1e-3. Report the 1e-3
        # fraction — the BASELINE control-error scale — alongside.
        secondary["corrected_obstacle_kkt_lt_1e3_frac"] = _frac(sols_c.kkt_residual < 1e-3)

    @cell
    def corrected_two_pass():
        # the production answer to the strict-convergence tail: fast first
        # pass + compacted cold/warm long-schedule rescue, one jit
        from ros2_mpc_jax.solver import make_pallas_two_pass_point_stab

        solve_tp = jax.jit(
            make_pallas_two_pass_point_stab(prob.ocp, SolverSettings.fast(), capacity=512)
        )
        sols_tp = jax.block_until_ready(solve_tp(thetas_c, U0))
        secondary["corrected_two_pass_solves_per_s"] = round(
            BATCH / _stream_rate(solve_tp, (thetas_c, U0), k=8), 1
        )
        secondary["corrected_two_pass_converged_frac"] = _frac(sols_tp.converged)

    @cell
    def hybrid():
        # MPPI exploration seeding the iLQR polish on a 1024-scenario slice
        # of the corrected bank, beside the plain vmap engine on that slice
        from ros2_mpc_jax.solver.mppi import make_hybrid_solver

        Bh = 1024
        sub_c = jax.tree_util.tree_map(lambda l: l[:Bh], thetas_c)
        keys_h = jax.random.split(jax.random.PRNGKey(0), Bh)
        hyb = jax.jit(jax.vmap(make_hybrid_solver(prob_c.ocp, prob_c.settings)))
        sols_h = jax.block_until_ready(hyb(sub_c, U0[:Bh], keys_h))
        t = _stream_rate(hyb, (sub_c, U0[:Bh], keys_h), k=1)
        sols_pv = jax.block_until_ready(jax.jit(jax.vmap(prob_c.solve))(sub_c, U0[:Bh]))
        secondary["hybrid_solves_per_s"] = round(Bh / t, 1)
        secondary["hybrid_converged_frac"] = _frac(sols_h.converged)
        secondary["hybrid_plain_vmap_converged_frac"] = _frac(sols_pv.converged)

    @cell
    def saddle():
        # adversarial saddle bank (B=4096, N=40, tools/demo_escape.py's
        # geometry at bank scale): plain single start; arc-seeded bank
        # multistart; multistart + compacted rescue + box-DDP KKT polish
        from ros2_mpc_jax.solver import (
            adversarial_saddle_bank,
            make_bank_multistart_solver,
            make_multistart_two_pass_solver,
        )

        prob_s = make_point_stabilization(params, horizon=40, reference_parity=False)
        thetas_s, U0_s = adversarial_saddle_bank(prob_s, BATCH, seed=0)
        plain_s = jax.jit(make_pallas_point_stab_solver(prob_s.ocp, prob_s.settings))
        ms_s = jax.jit(
            make_bank_multistart_solver(prob_s.ocp, prob_s.settings, swing_fracs=(1.0,))
        )
        comp_s = make_multistart_two_pass_solver(
            prob_s.ocp, prob_s.settings, capacity=512, swing_fracs=(1.0,), fuse=False
        )
        secondary["saddle_plain_converged_frac"] = _frac(plain_s(thetas_s, U0_s).converged)
        secondary["saddle_multistart_first_pass_converged_frac"] = _frac(
            ms_s(thetas_s, U0_s).converged
        )
        sols_sc = jax.block_until_ready(comp_s(thetas_s, U0_s))
        secondary["saddle_multistart_converged_frac"] = _frac(sols_sc.converged)
        secondary["saddle_multistart_solves_per_s"] = round(
            BATCH / _stream_rate(comp_s, (thetas_s, U0_s), k=4), 1
        )

    @cell
    def generic_models():
        # the ext model families at bank scale through the lane-aligned
        # engine's generic Cholesky path
        from ros2_mpc_jax.parallel import make_generic_fleet_rollout
        from ros2_mpc_jax.solver import (
            make_bicycle_point_stabilization,
            make_fast_polish_solver,
            make_quadrotor_hover,
        )
        from ros2_mpc_jax.solver.batched import make_bank_solver_fast

        rng = np.random.default_rng(2)
        prob_bi = make_bicycle_point_stabilization(params, horizon=N_HORIZON)
        th_bi = jax.vmap(prob_bi.make_theta)(
            jnp.asarray(rng.uniform(-0.3, 0.3, size=(BATCH, 3))),
            jnp.asarray(rng.uniform(-1.5, 1.5, size=(BATCH, 3))),
        )
        solve_bi = jax.jit(make_bank_solver_fast(prob_bi.ocp, prob_bi.settings))
        sols_bi = jax.block_until_ready(solve_bi(th_bi, U0))
        secondary["bicycle_solves_per_s"] = round(
            BATCH / _stream_rate(solve_bi, (th_bi, U0), k=8), 1
        )
        secondary["bicycle_converged_frac"] = _frac(sols_bi.converged)

        # quadrotor production config: fast-schedule first pass + compacted
        # box-DDP KKT polish (separately jitted stages, same numerics)
        prob_q = make_quadrotor_hover(horizon=N_HORIZON, settings=SolverSettings.fast())
        xq = np.zeros((BATCH, 12))
        xq[:, 0:3] = rng.uniform(-0.4, 0.4, size=(BATCH, 3))
        xq[:, 6:8] = rng.uniform(-0.15, 0.15, size=(BATCH, 2))
        xq[:, 8] = rng.uniform(-0.5, 0.5, size=BATCH)
        gq = np.concatenate(
            [rng.uniform(-0.3, 0.3, size=(BATCH, 3)), rng.uniform(-0.4, 0.4, size=(BATCH, 1))],
            axis=1,
        )
        th_q = jax.vmap(prob_q.make_theta)(jnp.asarray(xq), jnp.asarray(gq))
        U0_q = jnp.tile(prob_q.default_u0[None], (BATCH, 1, 1))
        solve_q = make_fast_polish_solver(prob_q.ocp, prob_q.settings, capacity=1536, fuse=False)
        sols_q = jax.block_until_ready(solve_q(th_q, U0_q))
        secondary["quadrotor_solves_per_s"] = round(
            BATCH / _stream_rate(solve_q, (th_q, U0_q), k=4), 1
        )
        secondary["quadrotor_converged_frac"] = _frac(sols_q.converged)

        # the generic closed-loop fleet: 1024 quadrotors solve-fly-shift to
        # per-robot goal poses, plant = the OCP's own transition
        prob_qf = make_quadrotor_hover(horizon=N_HORIZON, settings=SolverSettings.realtime())
        B_qf, T_qf = 1024, 40
        th_qf = jax.tree_util.tree_map(lambda l: l[:B_qf], th_q)
        roll_qf = make_generic_fleet_rollout(prob_qf, n_ticks=T_qf, goal_threshold=0.1)
        out_qf = jax.block_until_ready(roll_qf(th_qf, U0_q[:B_qf]))
        t = _stream_rate(roll_qf, (th_qf, U0_q[:B_qf]), k=1, rounds=3)
        secondary["quadrotor_fleet_robot_ticks_per_s"] = round(B_qf * T_qf / t, 1)
        secondary["quadrotor_fleet_reach_frac"] = round(float(out_qf.reach_fraction), 4)

    @cell
    def tracking():
        # tracking-problem bank on the tracking kernel, and its two-pass
        # rescue twin
        from ros2_mpc_jax.solver import make_pallas_two_pass_tracking

        prob_t = make_tracking(params, horizon=N_HORIZON)
        thetas_t, U0_t = tracking_bank(prob_t, BATCH, params.dt)
        solve_t = jax.jit(make_pallas_tracking_solver(prob_t.ocp, prob_t.settings))
        sols_t = jax.block_until_ready(solve_t(thetas_t, U0_t))
        secondary["tracking_solves_per_s"] = round(
            BATCH / _stream_rate(solve_t, (thetas_t, U0_t), k=8), 1
        )
        secondary["tracking_converged_frac"] = _frac(sols_t.converged)
        solve_t2 = jax.jit(
            make_pallas_two_pass_tracking(prob_t.ocp, SolverSettings.fast(), capacity=512)
        )
        sols_t2 = jax.block_until_ready(solve_t2(thetas_t, U0_t))
        secondary["tracking_two_pass_solves_per_s"] = round(
            BATCH / _stream_rate(solve_t2, (thetas_t, U0_t), k=8), 1
        )
        secondary["tracking_two_pass_converged_frac"] = _frac(sols_t2.converged)

    @cell
    def fast_schedule():
        # SolverSettings.fast: ~2x fewer iterations, the documented
        # speed/robustness knob
        prob_f = make_point_stabilization(
            params, horizon=N_HORIZON, settings=SolverSettings.fast()
        )
        solve_f = jax.jit(make_pallas_point_stab_solver(prob_f.ocp, prob_f.settings))
        sols_f = jax.block_until_ready(solve_f(thetas, U0))
        secondary["fast_schedule_solves_per_s"] = round(
            BATCH / _stream_rate(solve_f, (thetas, U0), k=8), 1
        )
        secondary["fast_schedule_converged_frac"] = _frac(sols_f.converged)

    @cell
    def device_resident_tick():
        # solve -> actuate -> shift in one lax.scan: the per-tick floor that
        # tick_packed_warm_* (one dispatch per tick) is compared against
        from ros2_mpc_jax.solver.packed import device_tick_rate

        dev_tick_s = device_tick_rate(prob_rt, n_ticks=64, dt=params.dt)
        secondary["tick_device_resident_ms"] = round(dev_tick_s * 1e3, 3)

    @cell
    def swarm():
        # 1024-robot coupled swarm: mutual avoidance through live obstacle
        # costs, per-tick B x B neighbor search + top_k, whole loop on device
        from ros2_mpc_jax.parallel import grid_swap_swarm, make_swarm_rollout

        prob_sw = make_point_stabilization(
            params, horizon=N_HORIZON, reference_parity=False,
            settings=SolverSettings.realtime(),
        )
        thetas_sw, U0_sw = grid_swap_swarm(prob_sw, side=32, pitch=2.0)
        T_sw = 128
        roll_sw = make_swarm_rollout(
            prob_sw, n_ticks=T_sw, dt=params.dt, k_neighbors=4, engine="pallas"
        )
        out_sw = jax.block_until_ready(roll_sw(thetas_sw, U0_sw))
        t = _stream_rate(roll_sw, (thetas_sw, U0_sw), k=1, rounds=3)
        secondary["swarm_robot_ticks_per_s"] = round(1024 * T_sw / t, 1)
        secondary["swarm_tick_ms"] = round(t / T_sw * 1e3, 3)
        secondary["swarm_min_separation_m"] = round(float(out_sw.min_separation), 3)

    @cell
    def tracking_fleet():
        # the reference's flagship path-following loop at fleet scale: 1024
        # robots each following its own arc path, reference windows
        # regenerated on device every tick, corrected parking mode
        from ros2_mpc_jax.parallel import arc_path_fleet, make_tracking_fleet_rollout

        prob_tf = make_tracking(
            params, horizon=N_HORIZON, reference_parity=False,
            settings=SolverSettings.realtime(), terminal_weight=(10.0, 10.0, 1.0),
        )
        B_tf, T_tf = 1024, 64
        thetas_tf, paths_tf, U0_tf = arc_path_fleet(prob_tf, B_tf, n_waypoints=64, seed=0)
        roll_tf = make_tracking_fleet_rollout(
            prob_tf, n_ticks=T_tf, dt=params.dt, goal_threshold=0.25, engine="pallas"
        )
        out_tf = jax.block_until_ready(roll_tf(thetas_tf, paths_tf, U0_tf))
        t = _stream_rate(roll_tf, (thetas_tf, paths_tf, U0_tf), k=1, rounds=3)
        secondary["tracking_fleet_robot_ticks_per_s"] = round(B_tf * T_tf / t, 1)
        secondary["tracking_fleet_tick_ms"] = round(t / T_tf * 1e3, 3)
        secondary["tracking_fleet_reach_frac"] = round(float(out_tf.reach_fraction), 4)
        secondary["tracking_fleet_mean_cross_track_m"] = round(
            float(out_tf.mean_cross_track), 4
        )

    @cell
    def packed_tick():
        # the live follower path: one packed transfer down, solve + in-jit
        # warm-start shift, the warm start fed straight back
        from ros2_mpc_jax.solver.packed import make_packed_point_stab

        solve_pk, pack = make_packed_point_stab(prob_rt, params)
        solve_pk = jax.jit(solve_pk)
        far = np.full(params.n_obstacle_points, 100.0)
        vec = pack(np.asarray(thetas["x0"][0]), np.asarray(thetas["goal"][0]), far, far)
        Uw1 = np.asarray(U_warm[0])
        jax.block_until_ready(solve_pk(vec, Uw1))
        lp = []
        for _ in range(30):
            t0 = time.perf_counter()
            sol_pk, Uw_dev = jax.block_until_ready(solve_pk(vec, Uw1))
            Uw1 = Uw_dev
            lp.append(time.perf_counter() - t0)
        secondary["tick_packed_warm_p50_ms"] = round(float(np.percentile(lp, 50)) * 1e3, 2)
        secondary["tick_packed_warm_p99_ms"] = round(float(np.percentile(lp, 99)) * 1e3, 2)

    @cell
    def roofline():
        # achieved op rate of the headline kernel against the rates XLA's
        # own code reaches per op class on this device (utils/roofline.py):
        # the analytic op ledger x on-device executed-work counters
        from ros2_mpc_jax.utils import roofline as rl

        rates = rl.measure_xla_op_rates()
        secondary["op_fma_tflops"] = round(rates["fma_flops_per_s"] / 1e12, 3)
        secondary["op_exp_gops"] = round(rates["exp_per_s"] / 1e9, 1)
        secondary["op_log_gops"] = round(rates["log_per_s"] / 1e9, 1)
        secondary["op_sincos_gops"] = round(rates["sincos_per_s"] / 1e9, 1)
        secondary["xla_loop_trip_us"] = round(rl.measure_loop_overhead() * 1e6, 3)
        solve_cnt = jax.jit(
            make_pallas_point_stab_solver(prob.ocp, prob.settings, with_counters=True)
        )
        for tag, th, P in (
            ("", thetas, np.zeros(BATCH)),
            ("corrected_", thetas_c,
             rl.computed_obstacle_points(bank["obs_x"], bank["obs_y"], np.ones(BATCH))),
        ):
            _, cnt = jax.block_until_ready(solve_cnt(th, U0))
            count = rl.bank_flops(
                rl.point_stab_solve_flops, N_HORIZON, P,
                np.asarray(cnt["iters"]), np.asarray(cnt["ls_rollouts"]), fast_sincos=True,
            )
            seconds = BATCH / (
                solves_per_s if not tag else secondary["corrected_obstacle_solves_per_s"]
            )
            rep = rl.roofline_report(
                count, seconds, rates,
                hbm_bytes=BATCH * rl.point_stab_hbm_bytes(N_HORIZON, params.n_obstacle_points),
            )
            secondary[f"{tag}flops_per_solve"] = round(count.total_flops / BATCH, 1)
            secondary[f"{tag}achieved_gflops"] = round(rep["achieved_gflops"], 1)
            secondary[f"{tag}pct_xla_fma_rate"] = round(rep["pct_xla_fma_rate"], 2)
            secondary[f"{tag}xla_model_time_ratio"] = round(rep["xla_model_time_ratio"], 3)
        secondary["transcendental_frac"] = round(rep["transcendental_frac"], 3)

    secondary["tick_warm_p50_ms"] = round(float(np.percentile(lat_w, 50)) * 1e3, 2)
    secondary["tick_warm_p99_ms"] = round(float(np.percentile(lat_w, 99)) * 1e3, 2)
    secondary["tick_cold_p50_ms"] = round(float(np.percentile(lat, 50)) * 1e3, 2)
    secondary["single_dispatch_solves_per_s"] = round(BATCH / single_dispatch_s, 1)

    print(
        f"engine=pallas batch={BATCH} N={N_HORIZON} sustained={solves_per_s:.1f}/s (K={K}) "
        f"per-solve={1e6 / solves_per_s:.2f} us converged={frac_conv * 100:.1f}% "
        f"card={card} tick_latency_cold_p50={np.percentile(lat, 50) * 1e3:.2f}ms "
        f"warm_p50={np.percentile(lat_w, 50) * 1e3:.2f}ms "
        f"warm_p99={np.percentile(lat_w, 99) * 1e3:.2f}ms (budget 200ms) "
        f"secondary={secondary} failed_cells={failed}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "nmpc_solves_per_s_per_device_N20",
                "value": round(solves_per_s, 1),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / TARGET_SOLVES_PER_S, 3),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
                "secondary": secondary,
            }
        )
    )
    if failed:
        raise SystemExit(f"bench: {len(failed)} cell(s) failed: {failed}")


if __name__ == "__main__":
    main()
