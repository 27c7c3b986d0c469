"""On-device occupancy mapping: log-odds scan fusion with known poses.

The reference cannot build maps — it consumes a cartographer-built PGM
(maps/map_carto.yaml) and republishes it (core/map_server.py); mapping is
delegated to an external SLAM stack. With localization given (the same tf
chain the reference consumes), occupancy mapping itself is a pure scatter
workload that fits the accelerator exactly like the costmap kernels (ops/grid.py):
every lidar beam contributes free-space evidence along the ray and occupied
evidence at the endpoint, accumulated in log-odds.

Update rule (standard binary Bayes filter, Thrun et al. ch. 9):

    L[cell] += l_occ   for the beam endpoint (a return inside max_range)
    L[cell] -= l_free  for cells traversed before the endpoint
    p(occupied) = sigmoid(L), clamped to +/- l_max to stay revisable

One jitted update processes the whole scan as a fused (B beams x T samples)
scatter-add — no Python per-beam loop. Grid convention matches the PGM/sim
world: row 0 = top, ``origin`` = world xy of the bottom-left corner.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(3, 7, 8))  # n_beams, resolution, max_range
# set the static sample grid (n_steps) and must be Python numbers
def logodds_update(
    L,  # (H, W) float32 log-odds
    pose,  # (3,) x, y, yaw
    ranges,  # (B,) lidar returns in the robot frame (inf = no return)
    n_beams: int,
    angle_min,
    angle_max,
    origin,  # (2,) world meters of the bottom-left corner
    resolution,
    max_range: float,
    l_occ: float = 0.85,
    l_free: float = 0.4,
    l_max: float = 8.0,
):
    """One scan folded into the log-odds grid; returns the new grid."""
    H, W = L.shape
    step = resolution / 2.0
    n_steps = int(max_range / step)
    beams = pose[2] + angle_min + jnp.arange(n_beams) * (angle_max - angle_min) / n_beams
    ts = (jnp.arange(n_steps) + 1.0) * step  # (T,)
    r = jnp.where(jnp.isfinite(ranges), ranges, jnp.inf)  # (B,)

    px = pose[0] + jnp.cos(beams)[:, None] * ts[None, :]  # (B, T)
    py = pose[1] + jnp.sin(beams)[:, None] * ts[None, :]
    # floor, not int-truncation: points one cell outside the left/bottom
    # edge would otherwise truncate toward zero, pass the bounds check, and
    # deposit evidence on border cells
    col = jnp.floor((px - origin[0]) / resolution).astype(jnp.int32)
    row = H - 1 - jnp.floor((py - origin[1]) / resolution).astype(jnp.int32)
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)

    # free space strictly before the return; occupied at the SINGLE sample
    # nearest the return — a +/-window would thicken every wall by a cell
    # per side, which after the planner's dilation seals real doorways in
    # the self-built map (measured: exploration runs stall on it)
    free = ts[None, :] < (r[:, None] - resolution)
    end_idx = jnp.clip(jnp.round(r / step).astype(jnp.int32) - 1, 0, n_steps - 1)
    # a return BEYOND max_range carves free space but must not stamp a
    # phantom wall at the clipped last sample (a max_range ring around the
    # robot when the sensor outranges the mapper)
    hit_in_range = jnp.isfinite(r) & (r <= max_range)
    occ = (jnp.arange(n_steps)[None, :] == end_idx[:, None]) & hit_in_range[:, None]
    # each beam stamps a cell at most once per sample; duplicate samples in
    # one cell (adjacent ts landing in the same cell) slightly over-count —
    # the standard grid-mapping approximation, bounded by the l_max clamp
    delta = jnp.where(occ, l_occ, 0.0) - jnp.where(free, l_free, 0.0)
    delta = jnp.where(inside & (ts[None, :] <= max_range), delta, 0.0)

    L = L.at[jnp.clip(row, 0, H - 1), jnp.clip(col, 0, W - 1)].add(delta)
    return jnp.clip(L, -l_max, l_max)


def occupancy_probability(L) -> jnp.ndarray:
    """p(occupied) per cell."""
    return jax.nn.sigmoid(L)
