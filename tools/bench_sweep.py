"""Monte-Carlo tuning sweep at BASELINE config-5 scale: 25 (Q, R) weight
configs x 4096 scenarios = 102,400 N=20 NMPC solves per sweep tick (the
"~100k solves/tick" target), evaluated with the whole-solver Pallas kernel
(compiled on a GPU, interpreted on the CPU). Writes a JSON artifact
(default SWEEP.json; pass the output path as argv[1]).

On several devices the same sweep shards over the global mesh
(parallel/mesh.py + parallel/distributed.py); this artifact records the
one-device number the sharded run divides by.
"""

from __future__ import annotations

import json
import os
import sys
import time


# runnable as `python tools/bench_sweep.py` without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path: str = "SWEEP.json"):
    import jax

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel.sweep import SweepSpec, run_sweep
    from ros2_mpc_jax.solver import make_point_stabilization
    from ros2_mpc_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    params = Params()
    prob = make_point_stabilization(params, horizon=20)
    spec = SweepSpec(scenarios_per_config=4096)
    n_solves = len(spec.q_scales) * len(spec.r_scales) * spec.scenarios_per_config
    run_sweep(prob, spec, params=params, engine="pallas")  # compile
    t0 = time.perf_counter()
    out = run_sweep(prob, spec, params=params, engine="pallas")
    wall = time.perf_counter() - t0

    artifact = {
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "engine": "pallas",
        "n_configs": int(out["configs"].shape[0]),
        "scenarios_per_config": spec.scenarios_per_config,
        "n_solves_per_tick": n_solves,
        "sweep_tick_wall_s": round(wall, 3),
        "solves_per_s": round(n_solves / wall, 1),
        "best_config_qr_scales": [float(v) for v in out["best_config"]],
        "mean_goal_error_by_config": {
            f"q={q:g},r={r:g}": round(float(e), 4)
            for (q, r), e in zip(out["configs"], out["mean_goal_error"])
        },
    }
    with open(out_path, "w") as fh:
        json.dump(artifact, fh, indent=2)
    print(json.dumps(artifact, indent=2))


if __name__ == "__main__":
    main(*sys.argv[1:])
