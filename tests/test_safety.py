"""Safety monitor (nodes/safety.py): the command-chain collision guard the
reference lacks — its MPC output goes straight to the motors."""

import numpy as np

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.nodes.bus import LaserScan, MessageBus, Twist
from ros2_mpc_jax.nodes.launch import build_sim_stack
from ros2_mpc_jax.nodes.safety import SafetyMonitorNode
from ros2_mpc_jax.utils import pgm


def _scan(front=np.inf, rear=np.inf, n=360):
    """360-degree scan, all far except optional front/rear returns."""
    ranges = np.full(n, 10.0)
    angles = np.linspace(-np.pi, np.pi, n)
    if np.isfinite(front):
        ranges[np.abs(angles) < 0.1] = front
    if np.isfinite(rear):
        ranges[np.abs(np.abs(angles) - np.pi) < 0.1] = rear
    return LaserScan(ranges=ranges, angle_min=-np.pi, angle_max=np.pi)


def _gate(scan, v, w=0.0, stop=0.25):
    bus = MessageBus()
    mon = SafetyMonitorNode(bus, Params(), stop_distance=stop)
    bus.publish("/scan", scan)
    bus.publish("cmd_vel_raw", Twist(linear_x=v, angular_z=w))
    out, _ = bus.latest("cmd_vel")
    return out, mon


def test_blocks_forward_into_close_return():
    out, mon = _gate(_scan(front=0.15), v=0.1, w=0.05)
    assert out.linear_x == 0.0
    assert out.angular_z == 0.05  # rotation passes: turning away is the escape
    assert mon.n_blocked == 1 and mon.last_clearance < 0.25


def test_passes_forward_when_clear():
    out, mon = _gate(_scan(front=1.0), v=0.1)
    assert out.linear_x == 0.1
    assert mon.n_blocked == 0 and mon.n_passed == 1


def test_reverse_checks_rear_arc_not_front():
    # wall ahead, clear behind: reversing away must be allowed
    out, _ = _gate(_scan(front=0.1), v=-0.05)
    assert out.linear_x == -0.05
    # wall behind: reversing into it is blocked
    out, _ = _gate(_scan(rear=0.1), v=-0.05)
    assert out.linear_x == 0.0


def test_rotation_in_place_always_passes():
    out, mon = _gate(_scan(front=0.05, rear=0.05), v=0.0, w=0.2)
    assert out.angular_z == 0.2
    assert mon.n_blocked == 0


def test_missing_scan_does_not_freeze_commands():
    bus = MessageBus()
    SafetyMonitorNode(bus, Params())
    bus.publish("cmd_vel_raw", Twist(linear_x=0.1))
    out, _ = bus.latest("cmd_vel")
    assert out.linear_x == 0.1


def test_parity_follower_with_monitor_does_not_collide():
    """The reference-faithful parity follower drives straight into an
    unmapped pillar (tests/test_closed_loop.py pins that). With the safety
    monitor in the command chain the same run must NOT collide — the robot
    halts short of the pillar instead."""
    world = pgm.synthetic_indoor_map()
    clean = world.copy()
    world[143:147, 123:127] = 0  # pillar at world (0, -1), on the straight line

    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=20,
        map_image=world, map_info=dict(pgm.DEFAULT_MAP_INFO),
        planner_map_image=clean, reference_parity=True,
        safety_stop=0.3,
    )
    stack.publish_goal(1.0, -1.0)
    collided = False
    for _ in range(300):
        stack.tick()
        if stack.sim.in_collision():
            collided = True
            break
    assert not collided
    assert stack.safety.n_blocked > 0  # the guard actually fired
    # halted short of the pillar, not teleported away
    p = stack.sim.pose
    assert float(np.hypot(p[0], p[1] + 1.0)) > 0.15
