"""Occupancy mapper (nodes/mapper.py + ops/mapping.py): log-odds scan
fusion with known poses — mapping the reference delegates to an external
cartographer install. Driving the simulated robot must reconstruct the
walls it saw: high precision against the ground-truth map, free space
carved along the route, and revisable evidence (clamped log-odds)."""

import numpy as np
import pytest

from ros2_mpc_jax.nodes.launch import build_sim_stack
from ros2_mpc_jax.nodes.mapper import MapperNode
from ros2_mpc_jax.ops.costmap import dilate


def _drive_and_map(goals, max_ticks=250):
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12)
    mapper = MapperNode(stack.bus, stack.params, size_m=6.0, resolution=0.05)
    for g in goals:
        stack.publish_goal(*g)
        for _ in range(max_ticks):
            out = stack.tick()
            mapper.tick()
            if out["control"].get("status") == "goal_reached":
                break
    return stack, mapper


@pytest.mark.slow
def test_mapper_reconstructs_observed_walls():
    import jax.numpy as jnp

    stack, mapper = _drive_and_map([(0.4, -1.6), (-1.2, -1.0)])
    assert mapper.n_scans > 100
    occ = mapper.occupancy()

    # ground truth resampled onto the mapper grid frame
    img = stack.sim.map_image
    info = stack.sim.map_info
    res_t = float(info["resolution"])
    ox_t, oy_t = info["origin"][:2]
    H, W = occ.shape
    rows = np.arange(H)
    cols = np.arange(W)
    wx = mapper.origin[0] + (cols + 0.5) * mapper.resolution
    wy = mapper.origin[1] + (H - 1 - rows + 0.5) * mapper.resolution
    tc = np.clip(((wx - ox_t) / res_t).astype(int), 0, img.shape[1] - 1)
    tr = np.clip(
        img.shape[0] - 1 - ((wy - oy_t) / res_t).astype(int), 0, img.shape[0] - 1
    )
    truth_occ = (img[tr][:, tc] == 0)

    # precision: mapped walls must BE walls (1-cell tolerance for the
    # half-step ray quantization)
    truth_dilated = np.asarray(dilate(jnp.asarray(truth_occ * 255.0), 3, 1) > 0)
    mapped = occ == 100
    assert mapped.sum() > 50, "mapper found almost no walls"
    precision = (mapped & truth_dilated).sum() / mapped.sum()
    assert precision > 0.9, f"precision {precision:.2f}"

    # the traveled corridor is carved free, and unseen space stays unknown
    r0, c0 = np.argmin(np.abs(wy - (-1.3))), np.argmin(np.abs(wx - (-0.3)))
    assert occ[r0, c0] == 0, "traveled free space not mapped free"
    assert (occ == -1).mean() > 0.2, "everything claimed observed"


def test_logodds_clamp_keeps_map_revisable():
    """A wall observed many times then removed (door opened) must be
    re-learnable: the clamp bounds accumulated evidence."""
    import jax.numpy as jnp

    from ros2_mpc_jax.ops.mapping import logodds_update, occupancy_probability

    L = jnp.zeros((80, 80), jnp.float32)
    pose = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    origin = jnp.asarray([-2.0, -2.0], jnp.float32)
    n_beams = 36
    wall = jnp.full((n_beams,), 1.0, jnp.float32)      # returns at 1 m
    open_ = jnp.full((n_beams,), jnp.inf, jnp.float32)  # no returns
    for _ in range(50):
        L = logodds_update(L, pose, wall, n_beams, -0.3, 0.3, origin, 0.05, 3.0)
    wall_cell = np.unravel_index(int(np.argmax(np.asarray(L))), L.shape)
    assert float(occupancy_probability(L)[wall_cell]) > 0.95
    for _ in range(50):
        L = logodds_update(L, pose, open_, n_beams, -0.3, 0.3, origin, 0.05, 3.0)
    p = occupancy_probability(L)
    # the former wall is now confidently free, and NOTHING anywhere claims
    # occupancy (unobserved cells sit at exactly p = 0.5 prior)
    assert float(p[wall_cell]) < 0.35, "evidence not revisable"
    assert not bool((p > 0.5).any())


@pytest.mark.slow
def test_navigate_while_mapping():
    """map_source='mapper': /map starts fully unknown (planner optimism) and
    is built live from scans; the robot reaches a goal far beyond the lidar
    horizon, discovering walls on the way — the reference cannot navigate
    without its pre-built cartographer map at all."""
    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12,
        map_source="mapper",
    )
    assert float((stack.mapper.occupancy() == -1).mean()) > 0.95
    reached, ticks, pose = stack.run_to_goal((3.5, -1.8), max_ticks=500)
    assert reached, f"not reached after {ticks} ticks, pose={pose}"
    assert not stack.sim.in_collision()
    unknown = float((stack.mapper.occupancy() == -1).mean())
    assert unknown < 0.8, f"nothing was mapped (unknown={unknown:.2f})"
    # the live /map carries real walls now
    msg, _ = stack.bus.latest("/map")
    assert (np.asarray(msg.data) == 100).sum() > 50
