"""Block-shape sweep of the point-stabilization kernel, and the precision
check of the vmap reference, on one GPU.

    python tools/sweep_pallas_blocks.py [--batch 4096] [--horizon 20]

Prints the card's name and power limit, then one line per block shape
(``tile_s`` warps x ``tile_l`` scenarios per program; ``num_warps`` is
``tile_s``): best-of-5 blocking time on the inert and the corrected bank of
``solver/banks.py``. Then the vmap iLQR engine at the default matmul
precision against ``"highest"`` on both banks: whether float32 products of
the reference change its answers on this card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

# runnable as `python tools/sweep_pallas_blocks.py` without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKS = ((1, 32), (2, 32), (4, 32), (1, 64), (2, 64), (1, 128), (4, 128))


def _best_ms(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=20)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("sweep_pallas_blocks: needs a GPU")
    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.solver import make_point_stabilization
    from ros2_mpc_jax.solver.banks import point_stab_banks
    from ros2_mpc_jax.solver.pallas_kernel import make_pallas_point_stab_solver
    from ros2_mpc_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    params = Params()
    prob = make_point_stabilization(params, horizon=args.horizon)
    prob_c = make_point_stabilization(params, horizon=args.horizon, reference_parity=False)
    bank = point_stab_banks(prob, prob_c, args.batch, seed=0)
    for tile_s, tile_l in BLOCKS:
        row = []
        for p, th in ((prob, bank["thetas"]), (prob_c, bank["thetas_c"])):
            solve = jax.jit(
                make_pallas_point_stab_solver(p.ocp, p.settings, tile_s=tile_s, tile_l=tile_l)
            )
            row.append(_best_ms(solve, th, bank["U0"]))
        print(
            f"block {tile_s}x{tile_l} (num_warps {tile_s}): inert {row[0]:.3f} ms | "
            f"corrected {row[1]:.3f} ms | B={args.batch} N={args.horizon} | {card}",
            flush=True,
        )

    for name, p, th in (("inert", prob, bank["thetas"]), ("corrected", prob_c, bank["thetas_c"])):
        solve = jax.jit(jax.vmap(p.solve))
        default = jax.block_until_ready(solve(th, bank["U0"]))
        with jax.default_matmul_precision("highest"):
            highest = jax.block_until_ready(jax.jit(jax.vmap(p.solve))(th, bank["U0"]))
        du = np.abs(np.asarray(default.U) - np.asarray(highest.U))
        both = np.asarray(default.converged) & np.asarray(highest.converged)
        print(
            f"precision {name}: vmap default vs 'highest' max|dU| {du.max():.2e} over all "
            f"rows, {du[both].max() if both.any() else 0.0:.2e} on the {both.mean():.4f} "
            f"both converged | {card}",
            flush=True,
        )


if __name__ == "__main__":
    main()
