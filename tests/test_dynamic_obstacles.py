"""Dynamic (moving, unmapped) obstacle avoidance through the live scan path.

The simulator's moving discs (Simulator.moving_obstacles — also how
nodes/multi_robot.py renders other robots) let the lidar see objects that
exist in no map. The corrected stack must dodge a pedestrian patrolling
across its route using only scan-derived obstacle costs + scan-aware
replanning: the reference cannot do this at all (its obstacle costs are dead
code and its planner never sees the scan — SURVEY.md quirk #1)."""

import numpy as np
import pytest

from ros2_mpc_jax.nodes.launch import build_sim_stack


@pytest.mark.slow
def test_point_follower_dodges_patrolling_pedestrian():
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=16)
    params = stack.params
    tick = {"i": 0}

    def ped_pos():
        # a 0.15 m-radius pedestrian patrolling x=0.2, oscillating across
        # the robot's straight line (y=-1) with a 12 s period
        t = tick["i"] * params.dt
        return [(0.2, -1.1 + 0.35 * np.sin(2 * np.pi * t / 12.0))]

    stack.sim.moving_obstacles = ped_pos
    stack.publish_goal(1.0, -1.0)
    min_sep, reached = np.inf, False
    for i in range(400):
        tick["i"] = i
        out = stack.tick()
        p = out["pose"]
        c = ped_pos()[0]
        min_sep = min(min_sep, float(np.hypot(p[0] - c[0], p[1] - c[1])))
        assert not stack.sim.in_collision(), f"wall hit at {np.round(p, 2)}"
        if out["control"].get("status") == "goal_reached":
            reached = True
            break
    assert reached, f"never latched; min_sep={min_sep:.2f}"
    # clears the pedestrian body (0.15 m) plus a real margin
    assert min_sep > 0.3, f"min separation {min_sep:.2f} m"
