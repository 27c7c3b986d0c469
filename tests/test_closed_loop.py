"""Full-stack closed-loop integration: simulator + map server + global A*
planner + MPC follower over the in-process bus, asserting goal-reaching on a
synthetic indoor map — the capability the reference only ever validates on a
physical robot or an external Gazebo install (SURVEY.md §4)."""

import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.nodes.launch import build_sim_stack
from ros2_mpc_jax.utils import pgm

HORIZON = 12


@pytest.mark.slow
def test_tracking_follower_reaches_goal():
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    reached, ticks, pose = stack.run_to_goal((1.0, -1.0), max_ticks=300)
    assert reached, f"not reached after {ticks} ticks, pose={pose}"
    assert np.linalg.norm(pose[:2] - np.array([1.0, -1.0])) < 0.25
    assert not stack.sim.in_collision()
    # telemetry recorded every solve
    summary = stack.follower.telemetry.summary()
    assert summary["solve_s"]["p99"] > 0


@pytest.mark.slow
def test_point_follower_reaches_goal():
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    reached, ticks, pose = stack.run_to_goal((0.4, -1.6), max_ticks=300)
    assert reached, f"not reached after {ticks} ticks, pose={pose}"
    assert np.linalg.norm(pose[:2] - np.array([0.4, -1.6])) < Params().goal_threshold + 0.1
    assert not stack.sim.in_collision()


def test_global_planner_publishes_path():
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    stack.publish_goal(1.0, -1.0)
    out = stack.global_planner.tick()
    assert out["status"] in ("published", "goal_reached")
    path_xy, heading = stack.follower.robot_controller.get_path()
    assert path_xy is not None and len(path_xy) > 5
    # path endpoints near robot and goal in world coordinates
    assert np.linalg.norm(path_xy[0] - np.array([-1.0, -1.0])) < 0.5
    assert np.linalg.norm(path_xy[-1] - np.array([1.0, -1.0])) < 0.5


def test_costmap_nodes_publish():
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    out = stack.local_costmap.tick()
    assert out["status"] == "published"
    msg, _ = stack.bus.latest("/my_local_costmap")
    cells = Params().costmap_cells
    assert msg.data.shape == (cells, cells)
    out2 = stack.global_costmap.tick()
    assert out2["status"] == "published"
    msg2, _ = stack.bus.latest("/my_global_costmap")
    assert msg2.data.shape == pgm.synthetic_indoor_map().shape


def test_simulator_lidar_sees_walls():
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    scan, _ = stack.bus.latest("/scan")
    ranges = np.asarray(scan.ranges)
    assert ranges.shape == (360,)
    finite = ranges[np.isfinite(ranges)]
    assert len(finite) > 10  # walls within 3.5 m in the synthetic map
    assert finite.min() > 0.1


def test_failed_solve_degrades_gracefully():
    """The reference crashes on IPOPT failure (local_planner_tracking.py:74);
    our follower must fall back to the previous command on a NaN solve."""
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    stack.publish_goal(1.0, -1.0)
    stack.global_planner.tick()
    out = stack.follower.tick()
    assert out["status"] in ("tracking", "goal_reached")
    # Force a NaN goal through the pipeline: follower must not raise.
    stack.publish_goal(float("nan"), 0.0)
    try:
        stack.follower.tick()
    except Exception as e:  # noqa: BLE001
        pytest.fail(f"follower raised on pathological input: {e}")


@pytest.mark.slow
def test_unmapped_obstacle_corrected_vs_parity():
    """An obstacle visible only to the lidar (not in the planner's static
    map). Corrected mode re-routes the global plan from scan returns and
    keeps MPC soft costs live: the robot detours and reaches the goal.
    Parity mode reproduces the reference's behavior — planner blind to the
    scan, obstacle costs dead code — and drives straight into it."""
    world = pgm.synthetic_indoor_map()
    clean = world.copy()
    world[143:147, 123:127] = 0  # pillar at world (0, -1), on the straight line

    def run(parity):
        stack = build_sim_stack(
            follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=20,
            map_image=world, map_info=dict(pgm.DEFAULT_MAP_INFO),
            planner_map_image=clean, reference_parity=parity,
        )
        stack.publish_goal(1.0, -1.0)
        collided = reached = False
        min_clear = np.inf
        for _ in range(400):
            o = stack.tick()
            p = o["pose"]
            min_clear = min(min_clear, float(np.hypot(p[0], p[1] + 1.0)))
            if stack.sim.in_collision():
                collided = True
                break
            if o["control"].get("status") == "goal_reached":
                reached = True
                break
        return reached, collided, min_clear

    reached_c, collided_c, clear_c = run(parity=False)
    assert reached_c and not collided_c, f"corrected: reached={reached_c} collided={collided_c}"
    assert clear_c > 0.3, f"clearance {clear_c:.2f} m too small"

    reached_p, collided_p, _ = run(parity=True)
    assert collided_p and not reached_p  # the reference's faithful outcome


@pytest.mark.slow
def test_tracking_handoff_unmapped_obstacle():
    """The tracking follower's goal-approach handoff: with an unmapped pillar
    forcing a detour, it must still avoid, turn in, and latch the goal
    (pre-handoff it orbited indefinitely)."""
    world = pgm.synthetic_indoor_map()
    clean = world.copy()
    world[143:147, 123:127] = 0
    stack = build_sim_stack(
        follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=20,
        map_image=world, map_info=dict(pgm.DEFAULT_MAP_INFO),
        planner_map_image=clean,
    )
    stack.publish_goal(1.0, -1.0)
    reached = collided = False
    for _ in range(400):
        o = stack.tick()
        if stack.sim.in_collision():
            collided = True
            break
        if o["control"].get("status") == "goal_reached":
            reached = True
            break
    assert reached and not collided


def test_global_costmap_file_reload_variant():
    """#28: the nav variant re-reads the map from PGM every tick
    (core/global_costmap_publisher_nav.py:23-33)."""
    import os

    from ros2_mpc_jax.nodes.costmap_nodes import GlobalCostmapNode

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stack = build_sim_stack(follower="tracking", start_pose=(-1.0, -1.0, 0.0), horizon=HORIZON)
    node = GlobalCostmapNode(
        stack.bus,
        Params(),
        map_pgm_path=os.path.join(repo, "maps", "map_synthetic.pgm"),
        map_yaml_path=os.path.join(repo, "maps", "map_synthetic.yaml"),
        reload_map_every_tick=True,
    )
    stack.sim.publish_scan()  # node subscribed after the stack's priming
    stack.sim.publish_state()
    out = node.tick()
    assert out["status"] == "published"
    assert out["costmap"].shape == (250, 250)
    assert out["costmap"].max() > 0  # walls present
    out2 = node.tick()  # second tick re-reads the file
    assert out2["status"] == "published"


def test_noise_robust_goal_reaching():
    """TurtleBot3-class sensor/actuation noise (1 cm odom, 0.01 rad yaw, 1%
    scan, 5% actuation) must not break goal reaching — the reference runs on
    physical robots whose sensing is exactly this dirty."""
    noise = {"odom_xy": 0.01, "odom_yaw": 0.01, "scan": 0.01, "cmd": 0.05}
    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=20,
        noise=noise, noise_seed=3,
    )
    reached, ticks, pose = stack.run_to_goal((1.0, -1.0), max_ticks=300)
    assert reached, f"stalled at {np.round(pose, 2)} after {ticks} ticks"
    assert not stack.sim.in_collision()


def test_kidnapped_robot_recovers():
    """Teleporting the robot mid-run (relocalization jump / pickup) must not
    wedge the stack: the planner replans from the new pose and the follower
    still reaches the goal."""
    import jax.numpy as jnp

    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=20)
    stack.publish_goal(1.0, -1.0)
    for _ in range(30):
        stack.tick()
    # kidnap: drop it further from the goal. (A kidnap facing *away* also
    # recovers, but by an extremely slow reverse crawl with a long flat
    # plateau — the swapped reverse-penalty exponent, quirk #2, barely
    # discourages v < 0; ~780 ticks measured. Keep the test on the
    # forward-facing case.)
    stack.sim.pose = jnp.asarray([-1.6, -1.6, 0.3])
    reached = False
    for i in range(400):
        out = stack.tick()
        if out["control"].get("status") == "goal_reached":
            reached = True
            break
    assert reached, f"never recovered; final pose {np.round(np.asarray(stack.sim.pose), 2)}"
    assert not stack.sim.in_collision()


def test_sequential_goals_retask():
    """Publishing a new goal after a latch must un-latch the follower and
    drive the next leg (multi-goal missions; the reference supports this
    implicitly through its goal-distance latch logic)."""
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=20)
    reached1, t1, pose1 = stack.run_to_goal((0.2, -1.0), max_ticks=300)
    assert reached1
    reached2, t2, pose2 = stack.run_to_goal((1.2, -1.4), max_ticks=300)
    assert reached2, f"second leg stalled at {np.round(pose2, 2)}"
    assert np.linalg.norm(np.asarray(pose2[:2]) - (1.2, -1.4)) <= stack.params.goal_threshold + 0.1
