"""Scaling-efficiency benchmark harness (BASELINE target: >= 80% efficiency
from 1 chip to >= 2 hosts).

Measures bank-solve throughput at 1 device vs n devices on whatever mesh is
available — the GPUs of one host (or several, after
``parallel.distributed.initialize``), or the virtual CPU mesh in CI, where it
validates the harness and the GSPMD/shard_map partitioning rather than
silicon scaling. The workload is embarrassingly parallel across scenarios, so
the measured inefficiency isolates partitioning overhead + the collective
telemetry reductions (scalar latency-bound all-reduces).

``main()`` runs every engine ('vmap', 'fast', 'pallas', 'mppi') and persists
the results as a JSON artifact (default ``SCALING.json`` at the repo root) so
each round's numbers are comparable across hardware.
"""

from __future__ import annotations

import json
import time


def run(
    per_device_batch: int = 512,
    horizon: int = 20,
    reps: int = 3,
    engine: str = "vmap",
    solver_settings=None,
    **engine_opts,
):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..config import Params
    from ..solver import make_point_stabilization
    from .mesh import make_bank_solver, make_mesh, shard_bank

    params = Params()
    prob = make_point_stabilization(params, horizon=horizon, settings=solver_settings)
    n_dev = len(jax.devices())
    results = {}
    for nd in sorted({1, n_dev}):
        B = per_device_batch * nd
        rng = np.random.default_rng(0)
        thetas = jax.vmap(prob.make_theta)(
            jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, 3))),
            jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, 3))),
        )
        U0 = jnp.zeros((B, horizon, 2))
        mesh = make_mesh(nd)
        step = make_bank_solver(prob, mesh, engine=engine, **engine_opts)
        thetas = shard_bank(thetas, mesh)
        U0 = shard_bank(U0, mesh)
        jax.block_until_ready(step(thetas, U0))  # compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(step(thetas, U0))
            times.append(time.perf_counter() - t0)
        best = min(times)
        results[nd] = B / best
    eff = results[n_dev] / (results[1] * n_dev) if n_dev > 1 else 1.0
    return {
        "engine": engine,
        "devices": n_dev,
        "per_device_batch": per_device_batch,
        "horizon": horizon,
        "solves_per_s_1dev": results[1],
        "solves_per_s_ndev": results.get(n_dev, results[1]),
        "scaling_efficiency": eff,
    }


def _largest_dividing_pow2(n: int, cap: int) -> int:
    """Largest power of two <= cap that divides n (n >= 1)."""
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def run_all_engines(per_device_batch: int = 512, horizon: int = 20, reps: int = 3):
    """One scaling measurement per engine, with packing opts sized to the
    per-device batch — lanes/tiles must *divide* it, so non-power-of-two
    batches (e.g. 192) get the largest dividing power of two instead of a
    blind min(128, B) that would crash the fast/pallas reshapes.

    On a virtual CPU mesh the raw ``scaling_efficiency`` is bounded above by
    ``physical_cores / devices`` for engines whose single-device baseline
    already saturates the host (XLA's intra-op threadpool): N virtual
    devices add no silicon. The artifact therefore also records that
    contention ceiling and ``efficiency_vs_ceiling`` — the number that
    isolates GSPMD/shard_map partitioning overhead, which is what the CPU
    mesh can actually validate. On real multi-chip hardware the ceiling is
    1.0 and both fields coincide (BASELINE target: >= 80%)."""
    import os

    import jax

    lanes = _largest_dividing_pow2(per_device_batch, 128)
    tile_l = lanes
    tile_s = _largest_dividing_pow2(per_device_batch // tile_l, 8)
    from ..solver.ilqr import SolverSettings
    from ..solver.mppi import MppiSettings

    # Production composites run a short schedule here: what's being measured
    # is partitioning + collective overhead, and the interpret-mode Pallas
    # passes inside two_pass would otherwise dominate the CPU-mesh wall
    # clock. On the GPU the bench (bench.py) carries their full-schedule
    # throughput.
    short = SolverSettings(barrier_stages=3, iters_per_stage=2, n_alphas=4)
    ms_lanes = _largest_dividing_pow2(3 * per_device_batch, lanes)
    cap = max(1, per_device_batch // 4)
    engines = {
        "vmap": {},
        "fast": {"lanes": lanes},
        "pallas": {"tile_s": tile_s, "tile_l": tile_l},
        # sampling family, short schedule: the point is the partitioning
        # overhead of an embarrassingly parallel rollout workload, not the
        # exploration quality
        "mppi": {"settings": MppiSettings(n_samples=32, n_iters=4)},
        "two_pass": {
            "solver_settings": short,
            "capacity": tile_s * tile_l // 2,
            "tile_s": tile_s,
            "tile_l": tile_l,
            "rescue_settings": short,
        },
        "multistart_bank": {
            "solver_settings": short,
            "swing_fracs": (1.0,),
            "inner_engine": "fast",
            "lanes": ms_lanes,
        },
        "multistart_rescue": {
            "solver_settings": short,
            "swing_fracs": (1.0,),
            "inner_engine": "fast",
            "lanes": ms_lanes,
            "capacity": cap,
            "rescue_settings": short,
            "polish_iters": 2,
        },
    }
    n_dev = len(jax.devices())
    on_cpu = jax.default_backend() == "cpu"
    ceiling = min(1.0, (os.cpu_count() or 1) / n_dev) if on_cpu else 1.0
    out = {
        "backend": jax.default_backend(),
        "devices": n_dev,
        "physical_cores": os.cpu_count(),
        "contention_ceiling": ceiling,
        "results": [],
    }
    for engine, opts in engines.items():
        r = run(per_device_batch, horizon, reps, engine=engine, **opts)
        r["efficiency_vs_ceiling"] = min(1.0, r["scaling_efficiency"] / ceiling)
        out["results"].append(r)
    return out


def run_distributed(timeout: float = 600.0):
    """Launch the 2-process x 4-virtual-device jax.distributed scaling
    measurement (tests/dist_scaling_worker.py) over local TCP — the
    multi-host analogue: the global-mesh step's telemetry all-reduces cross
    the OS-process boundary every dispatch. Returns the worker's artifact
    dict (per-engine 1-dev vs 8-dev-global throughput + efficiency)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    worker = os.path.join(repo, "tests", "dist_scaling_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, worker],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outputs = [p.communicate(timeout=timeout)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f"distributed scaling worker {pid} failed:\n{out}")
    for out in outputs:
        for line in out.splitlines():
            if line.startswith("DIST_SCALING_OK "):
                return json.loads(line[len("DIST_SCALING_OK "):])
    raise RuntimeError(f"no DIST_SCALING_OK line:\n{outputs}")


def probe_single_device_core_usage(engine: str = "vmap", per_device_batch: int = 512):
    """Decompose the virtual-mesh efficiency gap: how many physical cores
    does the 1-device baseline itself consume?

    The contention ceiling (cores / devices) assumes the single-device
    baseline uses ONE core — but XLA:CPU parallelizes one device's program
    across its intra-op threadpool, so engines whose baseline already eats
    both cores (vmap's batched jacobians, mppi's sample rollouts) make the
    naive ceiling unreachable by construction. This probe times the 1-device
    solve unpinned vs pinned to one core (``taskset -c 0``): the ratio IS
    the baseline's effective core usage, and (cores / devices) /
    baseline_cores is the corrected ceiling. Returns the dict
    {unpinned_solves_per_s, pinned_solves_per_s, baseline_core_usage}."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = (
        "from ros2_mpc_jax.parallel.scaling_bench import run;"
        f"r = run({per_device_batch}, 20, 3, engine={engine!r});"
        "print('PROBE', r['solves_per_s_1dev'])"
    )
    rates = {}
    for name, prefix in {"unpinned": [], "pinned": ["taskset", "-c", "0"]}.items():
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
        )
        out = subprocess.run(
            prefix + [sys.executable, "-c", code],
            env=env,
            capture_output=True,
            text=True,
            timeout=600,
        )
        if out.returncode != 0:
            raise RuntimeError(f"{name} probe failed:\n{out.stdout}\n{out.stderr}")
        for line in out.stdout.splitlines():
            if line.startswith("PROBE "):
                rates[name] = float(line.split()[1])
    return {
        "engine": engine,
        "unpinned_solves_per_s": rates["unpinned"],
        "pinned_solves_per_s": rates["pinned"],
        "baseline_core_usage": rates["unpinned"] / rates["pinned"],
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="SCALING.json", help="JSON artifact path")
    ap.add_argument(
        "--distributed",
        action="store_true",
        help="also run the 2-process jax.distributed (multi-host analogue) measurement",
    )
    ap.add_argument(
        "--decompose",
        action="store_true",
        help="probe the 1-device baseline's core usage (taskset-pinned rerun) "
        "for the engines that fall short of the naive contention ceiling",
    )
    args = ap.parse_args(argv)
    out = run_all_engines(args.per_device_batch, args.horizon, args.reps)
    if args.decompose:
        out["baseline_core_usage_probe"] = [
            probe_single_device_core_usage(e, args.per_device_batch)
            for e in ("vmap", "mppi")
        ]
    if args.distributed:
        out["distributed"] = run_distributed()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    for r in out["results"]:
        print(
            f"{r['engine']:>6}: devices={r['devices']} "
            f"1-dev={r['solves_per_s_1dev']:.0f}/s "
            f"n-dev={r['solves_per_s_ndev']:.0f}/s "
            f"efficiency={r['scaling_efficiency'] * 100:.1f}% "
            f"(vs contention ceiling {out['contention_ceiling'] * 100:.0f}%: "
            f"{r['efficiency_vs_ceiling'] * 100:.1f}%)"
        )
    for r in out.get("baseline_core_usage_probe", []):
        print(
            f"decompose {r['engine']}: 1-dev baseline uses "
            f"{r['baseline_core_usage']:.2f} cores -> corrected ceiling "
            f"{out['contention_ceiling'] / r['baseline_core_usage'] * 100:.1f}%"
        )
    for r in out.get("distributed", {}).get("results", []):
        print(
            f"dist {r['engine']:>6}: 1-dev={r['solves_per_s_1dev']:.0f}/s "
            f"8-dev-2proc={r['solves_per_s_ndev']:.0f}/s "
            f"efficiency={r['scaling_efficiency'] * 100:.1f}% "
            f"(vs ceiling: {r['efficiency_vs_ceiling'] * 100:.1f}%)"
        )


if __name__ == "__main__":
    main()
