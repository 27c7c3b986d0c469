"""Autonomous frontier exploration (planner/frontier.py + nodes/explorer.py):
no human goal, no prior map — the stack maps the reachable world by driving
to its own frontier goals, with the safety monitor guarding the corners the
carrot lookahead cuts. The reference needs a human goal AND a cartographer
map to move at all."""

import numpy as np
import pytest

from ros2_mpc_jax.nodes.explorer import ExplorerNode
from ros2_mpc_jax.nodes.launch import build_sim_stack
from ros2_mpc_jax.planner.frontier import (
    cluster_frontiers,
    frontier_cells,
    pick_frontier_goal,
)


def test_frontier_extraction_basics():
    occ = np.full((10, 10), -1, dtype=np.int8)
    occ[4:7, 4:7] = 0        # a free pocket inside unknown
    occ[5, 5] = 0
    occ[4, 4] = 100          # one wall corner
    mask = frontier_cells(occ)
    # interior free cell fully surrounded by free is NOT a frontier
    assert not mask[5, 5]
    # free cells on the pocket boundary ARE frontiers
    assert mask[4, 5] and mask[6, 6]
    # occupied cells never are
    assert not mask[4, 4]
    clusters = cluster_frontiers(mask, min_size=2)
    assert clusters and clusters[0]["size"] >= 2


def test_pick_frontier_goal_nearest_and_done():
    occ = np.full((20, 20), -1, dtype=np.int8)
    occ[10:14, 2:18] = 0
    goal = pick_frontier_goal(occ, (0.0, 0.0), origin=(-0.5, -0.5),
                              resolution=0.05, min_size=3, min_distance=0.05)
    assert goal is not None
    # a fully-known map has no frontier: exploration reports done
    occ_closed = np.zeros((20, 20), dtype=np.int8)
    assert pick_frontier_goal(occ_closed, (0.0, 0.0), (-0.5, -0.5), 0.05) is None


@pytest.mark.slow
def test_autonomous_exploration_maps_the_room():
    """From a fully-unknown map and NO human goal: the explorer must pick
    its own frontiers, map a large fraction of the world, abandon frontiers
    sealed by the planner's inflation (the narrow doorways), never collide
    (safety monitor), and terminate by itself."""
    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12,
        map_source="mapper", safety_stop=0.22,
    )
    explorer = ExplorerNode(stack.bus, stack.mapper, stack.params)
    complete = False
    for i in range(2500):
        if explorer.tick()["status"] == "complete":
            complete = True
            break
        stack.tick()
        assert not stack.sim.in_collision(), f"collided at tick {i}"
    assert complete, "exploration never terminated"
    assert explorer.n_goals >= 3  # multiple self-chosen goals
    unknown = float((stack.mapper.occupancy() == -1).mean())
    assert unknown < 0.6, f"too little mapped (unknown={unknown:.2f})"
    # the mapped free area spans the room, not just the start neighborhood
    occ = stack.mapper.occupancy()
    free_frac = float((occ == 0).mean())
    assert free_frac > 0.25, f"free fraction {free_frac:.2f}"
