"""Shared-world multi-robot simulation: mutual avoidance must fall out of
the existing scan-minus-map live obstacle machinery (no robot-to-robot
communication). The reference framework is single-robot per ROS domain;
MultiRobotSim is the honest analogue of K domains sharing one world."""

import numpy as np
import pytest

from ros2_mpc_jax.nodes.multi_robot import MultiRobotSim


@pytest.mark.slow
def test_two_robots_swap_positions_without_colliding():
    # Head-on swap along a corridor, goals offset laterally so the symmetric
    # deadlock is broken and each MPC has a preferred side to yield to.
    starts = [(-1.2, -1.0, 0.0), (1.2, -1.2, np.pi)]
    goals = [(1.2, -1.0), (-1.2, -1.2)]
    sim = MultiRobotSim(starts, follower="point", robot_radius=0.15)
    out = sim.run_to_goals(goals, max_ticks=500)
    assert all(out.reached), (
        f"reached={out.reached} after {out.ticks} ticks; "
        f"final poses {[np.round(tr[-1], 2) for tr in out.traces]}"
    )
    assert not out.collided_static
    # Two discs of radius 0.15 collide at separation 0.30.
    assert out.min_separation > 0.30, f"min separation {out.min_separation:.3f}"


def test_moving_obstacle_appears_in_scan():
    """The simulator's dynamic discs must show up as finite lidar returns at
    the analytically correct distance."""
    sim = MultiRobotSim([(-1.0, -1.0, 0.0)], follower="point").stacks[0].sim
    # Place one disc 1 m dead ahead (+x, heading 0).
    sim.moving_obstacles = lambda: [np.array([0.0, -1.0])]
    sim.obstacle_radius = 0.2
    sim.publish_scan()
    msg, _seq = sim.bus.latest("/scan")
    ranges = np.asarray(msg.ranges)
    # Beam 0 points along -pi; the forward beam is at index n_beams//2.
    fwd = ranges[len(ranges) // 2]
    assert np.isfinite(fwd)
    assert abs(fwd - 0.8) < 0.05, f"forward return {fwd:.3f}, expected ~0.8"
