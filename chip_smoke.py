"""Smoke test of the system on NVIDIA GPUs: the quickest proof that it runs.

Drives the main path once through the entry points a user calls, at the
sizes users run, and compares every result with the plain reference — the
vmap iLQR engine (solver/ilqr.py) under ``jax.default_matmul_precision
("highest")``. Each phase prints one result line; the last line is
``{"ok": true, "device": {...}}``. A failed phase, or a JAX that finds no
GPU, ends the script with a non-zero exit code and no such line.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --multi   # the four-card phase (and what it is compared with) only

Phases: 1 device; 2 the BASELINE config-4 banks (4096 scenarios, N=20,
inert and obstacle-active, plus the tracking bank) through the sharded bank
solver, timed beside the XLA bank engine; 3 the 1024-robot tracking fleet
closed loop; 4 the reference robot's closed loop (tracking follower, N=30,
5 Hz) on the simulated nav stack. ``--multi``: the bank sharded over four
cards vs one card, and the per-tick all_gather swarm vs its one-card twin.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL_U = 1e-3  # BASELINE oracle tolerance on rows both engines converged
TOL_SHARD = 1e-5  # sharded vs one-card answers: same kernel, same blocks
B_BANK, N_BANK = 4096, 20
FLEET_B, FLEET_T = 1024, 64
BUDGET_S = 0.2  # the reference's 5 Hz control tick


def phase_device(n_cards: int) -> str:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {card} | jax {jax.__version__} | {devs[0].device_kind} x{len(devs)}",
          flush=True)
    return card


def _timed(fn, *args, reps: int = 5):
    """(result, compile+first-call seconds, best of ``reps`` seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _reference(fn, *args):
    import jax

    with jax.default_matmul_precision("highest"):
        return _timed(fn, *args, reps=2)


def _max_du_converged(sol, ref) -> tuple[float, float]:
    both = np.asarray(sol.converged) & np.asarray(ref.converged)
    d = np.abs(np.asarray(sol.U) - np.asarray(ref.U))[both]
    return (float(d.max()) if d.size else 0.0), float(both.mean())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED {what}")


def phase_bank(card: str) -> None:
    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel import make_bank_solver, make_mesh
    from ros2_mpc_jax.solver import make_point_stabilization, make_tracking
    from ros2_mpc_jax.solver.banks import point_stab_banks, tracking_bank

    params = Params()
    mesh = make_mesh(1)
    prob = make_point_stabilization(params, horizon=N_BANK)
    prob_c = make_point_stabilization(params, horizon=N_BANK, reference_parity=False)
    bank = point_stab_banks(prob, prob_c, B_BANK, seed=0)
    prob_t = make_tracking(params, horizon=N_BANK)
    th_t, U0_t = tracking_bank(prob_t, B_BANK, params.dt)
    cases = [
        ("inert", prob, bank["thetas"], bank["U0"], 0.95),
        ("corrected", prob_c, bank["thetas_c"], bank["U0"], None),
        ("tracking", prob_t, th_t, U0_t, 0.95),
    ]
    for name, p, th, U0, min_conv in cases:
        (sol, _), c_k, t_k = _timed(make_bank_solver(p, mesh, engine="pallas"), th, U0)
        (ref, _), _, t_r = _reference(make_bank_solver(p, mesh, engine="vmap"), th, U0)
        _, _, t_f = _timed(make_bank_solver(p, mesh, engine="fast"), th, U0)
        du, both = _max_du_converged(sol, ref)
        conv = float(np.mean(np.asarray(sol.converged)))
        print(
            f"[2 bank {name}] B={B_BANK} N={N_BANK}: pallas {B_BANK / t_k:.0f} solves/s "
            f"({t_k * 1e3:.3f} ms, compile {c_k:.1f} s) | fast {B_BANK / t_f:.0f} solves/s "
            f"({t_f * 1e3:.3f} ms) | vmap reference {B_BANK / t_r:.0f} solves/s | "
            f"converged {conv:.4f} | max|dU| {du:.2e} on {both:.4f} of rows | {card}",
            flush=True,
        )
        _check(bool(np.isfinite(np.asarray(sol.U)).all()), f"{name}: non-finite controls")
        _check(du <= TOL_U, f"{name}: max|dU| {du:.2e} > {TOL_U}")
        if min_conv is not None:
            _check(conv >= min_conv, f"{name}: converged {conv:.4f} < {min_conv}")


def phase_tracking_fleet(card: str) -> None:
    import jax

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel import arc_path_fleet, make_tracking_fleet_rollout
    from ros2_mpc_jax.solver import SolverSettings, make_tracking

    params = Params()
    prob = make_tracking(
        params, horizon=N_BANK, reference_parity=False,
        settings=SolverSettings.realtime(), terminal_weight=(10.0, 10.0, 1.0),
    )
    B, T, K = FLEET_B, FLEET_T, 4
    thetas, paths, U0 = arc_path_fleet(prob, B, n_waypoints=64, seed=0)
    roll = make_tracking_fleet_rollout(
        prob, n_ticks=T, dt=params.dt, goal_threshold=0.25, record=True, engine="pallas"
    )
    res, c, t = _timed(roll, thetas, paths, U0, reps=3)
    reach = float(res.reach_fraction)
    # the reference rolls the first K ticks; a rollout's first K ticks do not
    # depend on how many follow
    ref_roll = make_tracking_fleet_rollout(
        prob, n_ticks=K, dt=params.dt, goal_threshold=0.25, record=True, engine="vmap"
    )
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(ref_roll(thetas, paths, U0))
    # robots whose first K solves converged in both engines: their states
    # after each of those ticks must agree within the oracle tolerance
    both = (np.asarray(res.converged)[:K] & np.asarray(ref.converged)).all(axis=0)
    d = np.abs(np.asarray(res.trajectories)[1 : K + 1] - np.asarray(ref.trajectories)[1:])
    per_robot = d.max(axis=(0, 2))
    dx = float(per_robot[both].max()) if both.any() else 0.0
    worst = int(np.argmax(per_robot))
    print(
        f"[3 tracking fleet] B={B} T={T}: {B * T / t:.0f} robot-ticks/s "
        f"({t / T * 1e3:.3f} ms/tick, compile {c:.1f} s) | reach {reach:.4f} | "
        f"mean cross-track {float(res.mean_cross_track):.4f} m | first {K} ticks vs vmap: "
        f"max|dx| {dx:.2e} on the {both.mean():.4f} of robots both converged; "
        f"over all robots max {per_robot[worst]:.2e} (robot {worst}, converged "
        f"{np.asarray(res.converged)[:K, worst].tolist()} vs "
        f"{np.asarray(ref.converged)[:, worst].tolist()}) | {card}",
        flush=True,
    )
    _check(reach >= 0.99, f"tracking fleet reach {reach:.4f} < 0.99")
    _check(bool(both.any()), "tracking fleet: no robot converged in both engines")
    _check(dx <= TOL_U, f"tracking fleet: max|dx| {dx:.2e} > {TOL_U} on converged robots")


def phase_closed_loop(card: str) -> None:
    import jax

    from ros2_mpc_jax.nodes.launch import build_sim_stack

    traced = []  # jit traces and compiles, to tell warm ticks from cold ones
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, *_a, **_k: traced.append(event)
        if event.startswith("/jax/core/compile/") else None
    )
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=30)
    ticks = []
    follower_tick = stack.follower.tick

    def timed_tick(*a, **k):
        n0 = len(traced)
        t0 = time.perf_counter()
        out = follower_tick(*a, **k)
        ticks.append((time.perf_counter() - t0, len(traced) > n0))
        return out

    stack.follower.tick = timed_tick
    reached, n, pose = stack.run_to_goal((1.0, -1.0))
    warm = np.asarray([s for s, cold in ticks if not cold])
    n_cold = sum(cold for _, cold in ticks)
    p50, p99 = (np.percentile(warm, [50, 99]) * 1e3) if warm.size else (np.nan, np.nan)
    print(
        f"[4 closed loop] tracking follower N=30 dt=0.2: reached={reached} in {n} ticks, "
        f"pose {np.round(np.asarray(pose), 3).tolist()} | warm tick p50 {p50:.2f} ms "
        f"p99 {p99:.2f} ms vs {BUDGET_S * 1e3:.0f} ms budget ({n_cold} ticks compiled) | {card}",
        flush=True,
    )
    _check(bool(reached), "closed loop did not reach the goal")


def phase_multi(card: str) -> None:
    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel import (
        grid_swap_swarm,
        make_bank_solver,
        make_mesh,
        make_sharded_swarm_rollout,
        make_swarm_rollout,
        shard_bank,
    )
    from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization
    from ros2_mpc_jax.solver.banks import point_stab_banks

    params = Params()
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    B = 4 * B_BANK
    prob = make_point_stabilization(params, horizon=N_BANK)
    prob_c = make_point_stabilization(params, horizon=N_BANK, reference_parity=False)
    bank = point_stab_banks(prob, prob_c, B, seed=0)
    th, U0 = bank["thetas_c"], bank["U0"]
    step4 = make_bank_solver(prob_c, mesh4, engine="pallas")
    (sol4, m4), c4, t4 = _timed(step4, shard_bank(th, mesh4), shard_bank(U0, mesh4))
    (sol1, _), _, t1 = _timed(make_bank_solver(prob_c, mesh1, engine="pallas"), th, U0)
    du = float(np.max(np.abs(np.asarray(sol4.U) - np.asarray(sol1.U))))
    print(
        f"[5 multi bank] B={B} corrected N={N_BANK}: 4 cards {B / t4:.0f} solves/s "
        f"({t4 * 1e3:.3f} ms) | 1 card {B / t1:.0f} solves/s ({t1 * 1e3:.3f} ms) | "
        f"scaling {t1 / t4 / 4:.3f} | max|dU| 4 vs 1 card {du:.2e} | "
        f"converged {float(m4['frac_converged']):.4f} | {card}",
        flush=True,
    )
    _check(du <= TOL_SHARD, f"sharded bank differs from one card by {du:.2e}")

    prob_sw = make_point_stabilization(
        params, horizon=N_BANK, reference_parity=False, settings=SolverSettings.realtime()
    )
    thetas_sw, U0_sw = grid_swap_swarm(prob_sw, side=32, pitch=2.0)
    T = 16
    roll4 = make_sharded_swarm_rollout(
        prob_sw, mesh4, n_ticks=T, dt=params.dt, k_neighbors=4, engine="pallas"
    )
    res4, c_s, t_s4 = _timed(
        roll4, shard_bank(thetas_sw, mesh4), shard_bank(U0_sw, mesh4), reps=3
    )
    roll1 = make_swarm_rollout(prob_sw, n_ticks=T, dt=params.dt, k_neighbors=4, engine="pallas")
    res1, _, t_s1 = _timed(roll1, thetas_sw, U0_sw, reps=3)
    dx = float(np.max(np.abs(np.asarray(res4.final_states) - np.asarray(res1.final_states))))
    print(
        f"[5 multi swarm] 1024 robots T={T}: 4 cards {t_s4 / T * 1e3:.3f} ms/tick | "
        f"1 card {t_s1 / T * 1e3:.3f} ms/tick | max|dx| 4 vs 1 card {dx:.2e} | "
        f"min separation {float(res4.min_separation):.3f} m | {card}",
        flush=True,
    )
    _check(dx <= TOL_U, f"sharded swarm differs from one card by {dx:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true", help="run the four-card phase only")
    args = ap.parse_args()
    n_cards = 4 if args.multi else 1
    card = phase_device(n_cards)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ros2_mpc_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.multi:
        phase_multi(card)
    else:
        phase_bank(card)
        phase_tracking_fleet(card)
        phase_closed_loop(card)

    import jax

    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
