"""Host-shim unit tests: bus semantics, topic ingestion quirks, reference
generation helpers, obstacle extraction, slew limiter."""

import numpy as np

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.nodes import MessageBus
from ros2_mpc_jax.nodes.bus import (
    Odometry,
    Pose,
    PoseStamped,
    Quaternion,
)
from ros2_mpc_jax.nodes.reference_gen import (
    get_goal_for_mpc,
    get_headings,
    get_obstacles,
    get_reference_trajectory,
    slew_limited_command,
)
from ros2_mpc_jax.nodes.state_publishers import TransformPublisherNode
from ros2_mpc_jax.nodes.topics import GoalSubscriber, OdomSubscriber

PARAMS = Params()


def yaw_quat(yaw):
    return Quaternion(z=np.sin(yaw / 2), w=np.cos(yaw / 2))


def test_bus_pull_semantics():
    bus = MessageBus()
    assert bus.latest("/x") == (None, 0)
    bus.publish("/x", 41)
    bus.publish("/x", 42)
    msg, seq = bus.latest("/x")
    assert msg == 42 and seq == 2


def test_odom_subscriber_rounds_to_2_decimals():
    """quirk #8: ingestion rounding (ros_topics.py:67-80)."""
    bus = MessageBus()
    sub = OdomSubscriber(bus)
    bus.publish(
        "/robot_position",
        Odometry(pose=Pose(x=1.23456, y=-0.98765, orientation=yaw_quat(0.5))),
    )
    pos, ori = sub.get_states()
    np.testing.assert_allclose(pos, [1.23, -0.99])
    np.testing.assert_allclose(ori[2], 0.5, atol=5e-3)


def test_goal_subscriber_five_vector():
    bus = MessageBus()
    sub = GoalSubscriber(bus)
    bus.publish("/goal_pose", PoseStamped(pose=Pose(x=2.0, y=3.0, orientation=yaw_quat(1.0))))
    goal = sub.get_goal()
    assert goal.shape == (5,)
    np.testing.assert_allclose(goal[:2], [2.0, 3.0])
    np.testing.assert_allclose(goal[4], 1.0, atol=5e-3)


def test_transform_publisher_negates_translation():
    """quirk #7 (transform_publisher.py:25-28)."""
    bus = MessageBus()
    TransformPublisherNode(bus)
    bus.publish("/odom", Odometry(pose=Pose(x=1.5, y=-2.5)))
    tf = bus.lookup_transform("map", "odom")
    assert tf.x == -1.5 and tf.y == 2.5


def test_get_headings_quirks():
    """quirk: omega = dheading/2, v = ||dxy||/dt * 2 (path_follower:14-23)."""
    path = np.array([[0.0, 0.0], [0.1, 0.0], [0.2, 0.1]])
    heading, vel, omega = get_headings(path, dt=0.2)
    np.testing.assert_allclose(heading[0], 0.0)
    np.testing.assert_allclose(heading[1], np.arctan2(0.1, 0.1))
    assert len(heading) == 3
    np.testing.assert_allclose(vel[0], 0.1 / 0.2 * 2)
    np.testing.assert_allclose(omega[0], (heading[1] - heading[0]) / 2)


def test_reference_trajectory_shapes_and_goal_tiling():
    N = 10
    path = np.stack([np.linspace(0, 2, 50), np.zeros(50)], axis=1)
    heading, vel, omega = get_headings(path, 0.2)
    goal = np.array([2.0, 0.0, 0.0, 0.0, 0.0])
    # far from the end: sliced reference
    pxf, puf = get_reference_trajectory(np.array([0.0, 0.0, 0.0]), goal, path, heading, vel, omega, N)
    assert pxf.shape == (3 * N, 1) and puf.shape == (2 * N, 1)
    # near the end: goal tiled (path_follower:32-33)
    pxf2, _ = get_reference_trajectory(np.array([1.9, 0.0, 0.0]), goal, path, heading, vel, omega, N)
    np.testing.assert_allclose(pxf2.reshape(N, 3), np.tile(goal[:3], (N, 1)))
    # nearest point at path end: padding path (path_follower:39-48)
    pxf3, puf3 = get_reference_trajectory(np.array([5.0, 3.0, 0.0]), goal, path, heading, vel, omega, N)
    assert pxf3.shape == (3 * N, 1) and puf3.shape == (2 * N, 1)


def test_carrot_selection():
    path = np.stack([np.linspace(0, 2, 21), np.zeros(21)], axis=1)
    heading = np.zeros(21)
    goal = np.array([2.0, 0.0, 0.0, 0.0, 1.0])
    pos = np.array([0.0, 0.0])
    carrot = get_goal_for_mpc(path, heading, goal, pos, lookahead_dist=0.5)
    assert np.linalg.norm(carrot[:2] - pos) > 0.5
    # within lookahead of the true goal: exact goal pose with yaw mod 2pi
    carrot2 = get_goal_for_mpc(path, heading, goal, np.array([1.8, 0.0]), 0.5)
    np.testing.assert_allclose(carrot2, [2.0, 0.0, 1.0])


def test_obstacle_extraction_normalized_vs_quirk():
    scan = np.full(360, np.inf)
    scan[0] = 1.0  # one return straight ahead
    angles = np.array([-np.pi, np.pi])
    pos = np.array([0.5, 0.5])
    ori = np.array([0.0, 0.0, 0.0])
    n = PARAMS.n_obstacle_points
    # working variant finds the obstacle cloud
    x_obs, y_obs = get_obstacles(scan, angles, PARAMS.costmap_size, PARAMS.resolution, pos, ori, n, normalized=True)
    assert x_obs.shape == (n,)
    assert np.any(np.abs(x_obs) < 50)  # something near the robot
    # quirk: the tracking node's un-normalized math always degenerates to
    # 100 m sentinels (path_follower:102,106,126-129)
    x_q, y_q = get_obstacles(scan, angles, PARAMS.costmap_size, PARAMS.resolution, pos, ori, n, normalized=False)
    np.testing.assert_allclose(x_q, 100.0)
    np.testing.assert_allclose(y_q, 100.0)


def test_all_inf_scan_phantom_self_obstacle():
    """Reference quirk: an all-inf scan turns NaN in the rotation matmul
    (inf - inf), NaN sanitizes to 0, and rasterizes a single phantom obstacle
    at the sensor's own cell (utils/utils.py:20-29 + :145-152). Faithfully
    reproduced; the padded vector broadcasts that one cell everywhere
    (quirk #10)."""
    scan = np.full(360, np.inf)
    angles = np.array([-np.pi, np.pi])
    n = PARAMS.n_obstacle_points
    x_obs, y_obs = get_obstacles(
        scan, angles, PARAMS.costmap_size, PARAMS.resolution, np.zeros(2), np.zeros(3), n, normalized=True
    )
    assert np.all(np.abs(x_obs) <= 0.1)
    assert np.all(np.abs(y_obs) <= 0.1)


def test_slew_limiter_quirk():
    """quirk #6: +slew on both channels regardless of sign
    (path_follower:197-203)."""
    u_last = np.array([0.0, 0.0])
    v, w, u_next = slew_limited_command(np.array([0.1, -0.1]), u_last, 0.03)
    assert v == 0.03 and w == 0.03  # both bumped +0.03 even though w error < 0
    np.testing.assert_allclose(u_next, [0.1, -0.1])
    # small change passes through
    v2, w2, _ = slew_limited_command(np.array([0.01, 0.01]), u_last, 0.03)
    assert v2 == 0.01 and w2 == 0.01


def test_mapped_structure_mask_and_scan_filter():
    """Unit-level checks of the scan-minus-map obstacle filtering
    (reference_gen.mapped_structure_mask / scan_to_world_obstacles):
    dilation matches a naive loop; wall returns are dropped while unmapped
    returns survive; off-map returns don't alias into border cells."""
    from ros2_mpc_jax.nodes.reference_gen import (
        mapped_structure_mask,
        scan_to_world_obstacles,
    )

    img = np.zeros((10, 12), dtype=np.uint8)
    img[4, 6] = 255  # one mapped cell
    mask = mapped_structure_mask(img, dilate_cells=2)
    naive = np.zeros_like(mask)
    for r in range(10):
        for c in range(12):
            naive[r, c] = any(
                img[rr, cc]
                for rr in range(max(0, r - 2), min(10, r + 3))
                for cc in range(max(0, c - 2), min(12, c + 3))
            )
    np.testing.assert_array_equal(mask, naive)

    # 1 m x 1.2 m map at 0.1 m: mapped cell (4, 6) covers world
    # x in [0.6, 0.7), y in [0.5, 0.6) (row 4 from top = row 5 from bottom).
    info = {"resolution": 0.1, "origin": (0.0, 0.0)}
    mask1 = mapped_structure_mask(img, dilate_cells=0)
    pos, yaw = np.array([0.65, 0.25]), np.pi / 2  # facing +y toward the cell
    # single-beam 'scan': ranges such that the return lands on the mapped
    # cell (0.3 m ahead -> y=0.55) vs an unmapped spot (0.1 m -> y=0.35)
    angles = (0.0, 2 * np.pi)
    x_on, y_on = scan_to_world_obstacles(
        [0.3], angles, 2.0, pos, yaw, 4, static_mask=mask1, map_info=info
    )
    assert np.all(x_on == 100.0), "mapped return should be filtered"
    x_off, y_off = scan_to_world_obstacles(
        [0.1], angles, 2.0, pos, yaw, 4, static_mask=mask1, map_info=info
    )
    assert abs(x_off[0] - 0.65) < 1e-6 and abs(y_off[0] - 0.35) < 1e-6

    # off-map return (negative world y): must NOT alias into border row
    img2 = np.zeros((10, 12), dtype=np.uint8)
    img2[9, :] = 255  # bottom row mapped
    mask2 = mapped_structure_mask(img2, dilate_cells=0)
    x_neg, y_neg = scan_to_world_obstacles(
        [0.3], angles, 2.0, np.array([0.65, 0.25]), -np.pi / 2, 4,
        static_mask=mask2, map_info=info,
    )
    # return at y = -0.05 is outside the map: kept as unmapped, not dropped
    # by the bottom-row mask via toward-zero truncation
    assert abs(y_neg[0] - (-0.05)) < 1e-6
