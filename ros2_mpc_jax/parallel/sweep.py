"""Pod-scale Monte-Carlo tuning sweeps (BASELINE.json config 5).

The reference tunes its weights by hand-editing one YAML and re-running a
robot (config/params.yaml; no sweep tooling exists). Here a sweep is a grid
over solver weights crossed with a bank of randomized scenarios, evaluated as
one sharded program: ``vmap`` over the flattened (config x scenario) axis,
sharded over the mesh, with per-config quality reduced by XLA collectives.

Checkpoint/resume: sweeps are chunked; completed chunk results are persisted
with ``np.savez`` so an interrupted sweep resumes at the next chunk — the
checkpoint/resume capability the reference lacks entirely (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import make_mesh, shard_bank


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Grid over (Q, R) scalings x scenarios for the point-stabilization
    problem. ``n_configs`` = len(q_scales) * len(r_scales)."""

    q_scales: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    r_scales: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    scenarios_per_config: int = 64
    seed: int = 0


def build_sweep_thetas(problem, spec: SweepSpec, params):
    """Flattened theta bank: (n_configs * scenarios_per_config, ...).

    Generic over the problem's state dimension: pose (x, y, theta) is
    randomized, any extra states (e.g. the smooth-actuation unicycle's
    velocities, solver/problems_ext.py) start at zero."""
    rng = np.random.default_rng(spec.seed)
    n_cfg = len(spec.q_scales) * len(spec.r_scales)
    B = n_cfg * spec.scenarios_per_config

    x0 = np.zeros((B, problem.ocp.n_states))
    x0[:, :3] = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.5, 1.5, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    thetas = jax.vmap(problem.make_theta)(jnp.asarray(x0), jnp.asarray(goal))

    qs, rs = np.meshgrid(spec.q_scales, spec.r_scales, indexing="ij")
    cfg = np.stack([qs.ravel(), rs.ravel()], axis=1)  # (n_cfg, 2)
    cfg_rep = np.repeat(cfg, spec.scenarios_per_config, axis=0)  # (B, 2)
    thetas = dict(thetas)
    thetas["Q"] = thetas["Q"] * jnp.asarray(cfg_rep[:, 0:1])
    thetas["R"] = thetas["R"] * jnp.asarray(cfg_rep[:, 1:2])
    return thetas, cfg


def run_sweep(
    problem,
    spec: SweepSpec = SweepSpec(),
    params=None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    chunk_size: int = 0,
    engine: str = "vmap",
    **engine_opts,
):
    """Evaluate the sweep; returns per-config mean terminal goal error.

    With ``checkpoint_path`` set, finished chunks are persisted and skipped on
    resume. ``engine``: 'vmap' | 'fast' | 'pallas', dispatched through
    :func:`~ros2_mpc_jax.parallel.mesh.make_bank_solver` (which owns kernel
    selection and the shard_map wrapping on
    multi-device meshes; chunk sizes must respect the engine's per-device
    lane/tile packing).
    """
    from ..config import Params
    from .mesh import make_bank_solver

    params = params or Params()
    mesh = mesh or make_mesh()
    thetas, cfg = build_sweep_thetas(problem, spec, params)
    B = int(jax.tree_util.tree_leaves(thetas)[0].shape[0])
    n_cfg = cfg.shape[0]
    per = spec.scenarios_per_config
    if chunk_size <= 0:
        chunk_size = B

    step = make_bank_solver(problem, mesh, engine=engine, **engine_opts)

    done = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            done = {int(k): ck[k] for k in ck.files}

    results = []
    for start in range(0, B, chunk_size):
        chunk_id = start // chunk_size
        if chunk_id in done:
            results.append(done[chunk_id])
            continue
        chunk = jax.tree_util.tree_map(lambda a: a[start : start + chunk_size], thetas)
        n = int(jax.tree_util.tree_leaves(chunk)[0].shape[0])
        chunk = shard_bank(chunk, mesh)
        U0 = shard_bank(jnp.zeros((n,) + problem.default_u0.shape), mesh)
        sols, _ = step(chunk, U0)
        # quality: distance of the terminal rollout state to the goal
        err = jnp.linalg.norm(sols.X[:, -1, :2] - chunk["goal"][:, :2], axis=-1)
        arr = np.asarray(err)
        results.append(arr)
        done[chunk_id] = arr
        if checkpoint_path:
            np.savez(checkpoint_path, **{str(k): v for k, v in done.items()})

    err_all = np.concatenate(results).reshape(n_cfg, per)
    return {
        "configs": cfg,
        "mean_goal_error": err_all.mean(axis=1),
        "best_config": cfg[int(np.argmin(err_all.mean(axis=1)))],
    }


def main():
    """Console entry: run the default tuning sweep and print the table
    (BASELINE.json config 5 scaled to the available mesh)."""
    from ..config import Params
    from ..solver import make_point_stabilization

    params = Params()
    prob = make_point_stabilization(params, horizon=20)
    spec = SweepSpec()
    out = run_sweep(prob, spec, params=params)
    print(f"{'Q scale':>8} {'R scale':>8} {'mean goal err [m]':>18}")
    for (q, r), e in zip(out["configs"], out["mean_goal_error"]):
        print(f"{q:8.2f} {r:8.2f} {e:18.4f}")
    print("best config (Q, R scales):", tuple(out["best_config"]))


if __name__ == "__main__":
    main()
