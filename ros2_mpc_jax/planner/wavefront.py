"""Accelerator-native global planning: batched wavefront distance fields.

The reference's only on-line planner is host-side sequential A*
(ros2_mpc/planner/global_planner.py:91-93 via pyastar2d). A* is inherently
serial (one heap pop at a time) and maps poorly onto a vector machine. The
data-parallel alternative is a *wavefront / min-plus relaxation*: iterate

    d <- min(d, min_neighbor(d) + w)

over the whole grid at once. Every sweep is one fused elementwise/shift
kernel over the full costmap; ``lax.while_loop`` runs sweeps until the field
is converged (bounded by the grid diameter). Batching goals just adds a
leading vmap axis — one program computes distance fields for thousands of
goals, which is what the Monte-Carlo scenario bank needs.

Path extraction is greedy steepest descent on the converged field (host-side
or scanned on the device) — the field itself is also directly useful as a dense
cost-to-go for the MPC reference generator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_BIG = 1e9


@partial(jax.jit, static_argnums=(2,))
def distance_field(weights: jnp.ndarray, goal_rc: jnp.ndarray, max_sweeps: int = 0):
    """Min-plus shortest-path distance-to-goal over a 4-neighborhood.

    ``weights``: (H, W) positive step costs (same convention as
    :func:`ros2_mpc_jax.planner.global_planner.astar_path` — e.g. free 1,
    obstacle 255). ``goal_rc``: (2,) int cell. Returns (H, W) distances.
    """
    H, W = weights.shape
    n_sweeps = max_sweeps if max_sweeps > 0 else (H + W)
    d0 = jnp.full((H, W), _BIG).at[goal_rc[0], goal_rc[1]].set(0.0)

    def relax(d):
        up = jnp.pad(d[1:, :], ((0, 1), (0, 0)), constant_values=_BIG)
        down = jnp.pad(d[:-1, :], ((1, 0), (0, 0)), constant_values=_BIG)
        left = jnp.pad(d[:, 1:], ((0, 0), (0, 1)), constant_values=_BIG)
        right = jnp.pad(d[:, :-1], ((0, 0), (1, 0)), constant_values=_BIG)
        best = jnp.minimum(jnp.minimum(up, down), jnp.minimum(left, right))
        return jnp.minimum(d, best + weights)

    def cond(state):
        d, prev, i = state
        return jnp.logical_and(i < n_sweeps, jnp.any(d != prev))

    def body(state):
        d, _, i = state
        return relax(d), d, i + 1

    d, _, _ = jax.lax.while_loop(cond, body, (relax(d0), d0, jnp.asarray(1)))
    return d


def extract_path(dist: np.ndarray, start_rc, max_len: int = 0) -> np.ndarray:
    """Greedy steepest descent from ``start_rc`` to the zero of the field.
    Returns (L, 2) (row, col) cells start-first; empty if start is
    disconnected."""
    d = np.asarray(dist)
    H, W = d.shape
    if max_len <= 0:
        max_len = H * W
    r, c = int(start_rc[0]), int(start_rc[1])
    if d[r, c] >= _BIG:
        return np.empty((0, 2), dtype=np.int32)
    path = [(r, c)]
    for _ in range(max_len):
        if d[r, c] == 0.0:
            break
        best = None
        for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= nr < H and 0 <= nc < W:
                if best is None or d[nr, nc] < d[best[0], best[1]]:
                    best = (nr, nc)
        if best is None or d[best[0], best[1]] >= d[r, c]:
            break
        r, c = best
        path.append((r, c))
    return np.asarray(path, dtype=np.int32)


def batched_distance_fields(weights: jnp.ndarray, goals_rc: jnp.ndarray):
    """vmap over goals: (G, 2) -> (G, H, W) distance fields in one program."""
    return jax.vmap(lambda g: distance_field(weights, g))(goals_rc)
