"""Multi-process node graph over the native shared-memory bus.

The reference's deployment shape is nine OS processes exchanging DDS topics
(launch/launch_all.launch.py:8-64, setup.py:28-40). The single-process
wall-clock graph (:mod:`~ros2_mpc_jax.nodes.live`) reproduces the rates; this
module reproduces the *process topology*: each role below runs as its own OS
process with its own rate scheduler, and every topic crosses a process
boundary through the C++ seqlock bus (native/shm_bus.cpp) — the framework's
DDS replacement.

Roles (mirroring the reference's process groups):

* ``world``    — simulator plant + lidar + localizer tf + robot state
  republisher + map server (on a physical robot this side is the hardware:
  drivers, cartographer, map server).
* ``planner``  — the global path publisher (A* + smoothing, 1 Hz).
* ``costmaps`` — local + global costmap publishers (10 Hz).
* ``follower`` — the MPC control loop (5 Hz), publishing ``cmd_vel`` and a
  ``_control_status`` heartbeat the supervisor watches for goal latching.
* ``safety``   — optional command-chain collision guard (nodes/safety.py) as
  its OWN process: the follower publishes ``cmd_vel_raw``, the monitor gates
  to ``cmd_vel``. Process isolation is the point — the last safety stage
  survives a crash of the planner or follower (the reference has no guard at
  all, and a failed IPOPT solve kills its node).

``run_multiprocess`` is the supervisor: it spawns the three compute roles,
runs the world role in-process, and broadcasts ``_shutdown`` once the
follower reports ``goal_reached`` (or the time budget expires).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import tempfile
import time
from typing import Optional

import numpy as np

from ..config import Params
from ..utils import pgm
from .bus import Pose, PoseStamped, Quaternion
from .costmap_nodes import GlobalCostmapNode, LocalCostmapNode
from .global_path_publisher import GlobalPathPublisherNode
from .live import RateScheduler, SimLocalization, Task
from .map_server import MapServerNode
from .path_follower import PathFollowerNode
from .point_follower import PointFollowerNode
from .shm_bus import SharedMemoryBus
from .sim import Simulator
from .state_publishers import RobotStatePublisherNode

log = logging.getLogger("multiproc")

SHUTDOWN_TOPIC = "_shutdown"
STATUS_TOPIC = "_control_status"
ROLES = ("world", "planner", "costmaps", "follower", "safety")
SAFETY_STATUS_TOPIC = "_safety_status"


def publish_goal(bus, x: float, y: float, yaw: float = 0.0):
    bus.publish(
        "/goal_pose",
        PoseStamped(
            pose=Pose(
                x=float(x),
                y=float(y),
                orientation=Quaternion(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))),
            )
        ),
    )


def _stop_requested(bus) -> bool:
    return bus.latest(SHUTDOWN_TOPIC)[1] > 0


def build_role_tasks(
    role: str,
    bus,
    params: Params,
    follower: str = "point",
    horizon: Optional[int] = None,
    start_pose=(-1.0, -1.0, 0.0),
    map_image=None,
    map_info=None,
    cmd_topic: str = "cmd_vel",
    safety_stop: float = 0.25,
):
    """(tasks, extras) for one role. Every role leads with a ``bus_spin``
    task — the rclpy.spin_once analogue pumping remote publishes into local
    callbacks — paced at twice the fastest consumer rate."""
    tasks = [Task("bus_spin", params.state_publish_period / 2, bus.spin_once)]
    extras: dict = {}
    if role == "world":
        if map_image is None:
            map_image = pgm.synthetic_indoor_map()
            map_info = dict(pgm.DEFAULT_MAP_INFO)
        sim = Simulator(bus, map_image, map_info, start_pose=start_pose, params=params)
        localizer = SimLocalization(bus, sim)
        robot_state = RobotStatePublisherNode(bus)
        map_server = MapServerNode(bus, map_image=map_image, map_info=map_info)
        plant_dt = params.dt / 4.0
        tasks += [
            # free-running plant: integrates the latest cmd_vel continuously,
            # as a physical robot would (the lock-step sim instead advances
            # inside the control tick)
            Task("plant", plant_dt, lambda: sim.step(plant_dt, publish=False)),
            Task("localizer", params.state_publish_period, localizer.tick),
            Task("robot_state", params.state_publish_period, robot_state.tick),
            Task("lidar", params.local_costmap_period, sim.publish_scan),
            Task("map_server", 1.0, map_server.tick),
        ]
        extras["sim"] = sim
    elif role == "planner":
        node = GlobalPathPublisherNode(bus, params)
        tasks.append(Task("replan", params.path_refresh_period, node.tick))
    elif role == "costmaps":
        tasks.append(
            Task("local_costmap", params.local_costmap_period, LocalCostmapNode(bus, params).tick)
        )
        tasks.append(
            Task("global_costmap", params.local_costmap_period, GlobalCostmapNode(bus, params).tick)
        )
    elif role == "follower":
        if follower == "tracking":
            ctrl = PathFollowerNode(bus, params, horizon=horizon, cmd_topic=cmd_topic)
        else:
            ctrl = PointFollowerNode(bus, params, horizon=horizon, cmd_topic=cmd_topic)

        def control_tick():
            out = ctrl.tick()
            bus.publish(STATUS_TOPIC, out.get("status"))
            return out

        tasks.append(Task("control", params.dt, control_tick))
        extras["ctrl"] = ctrl
    elif role == "safety":
        from .safety import SafetyMonitorNode

        monitor = SafetyMonitorNode(bus, params, stop_distance=safety_stop)

        def heartbeat():
            bus.publish(
                SAFETY_STATUS_TOPIC,
                {"blocked": monitor.n_blocked, "passed": monitor.n_passed},
            )

        # gating itself is event-driven off bus_spin; the 1 s heartbeat just
        # exposes the counters to the supervisor
        tasks.append(Task("safety_heartbeat", 1.0, heartbeat))
        extras["monitor"] = monitor
    else:
        raise ValueError(f"unknown role {role!r} (choose from {ROLES})")
    return tasks, extras


def run_role(
    role: str,
    bus_path: str,
    duration: float,
    follower: str = "point",
    horizon: Optional[int] = None,
    params: Optional[Params] = None,
    cmd_topic: str = "cmd_vel",
    safety_stop: float = 0.25,
) -> dict:
    """Run one role against an existing bus file until the duration expires
    or a ``_shutdown`` broadcast arrives."""
    params = params or Params()
    bus = SharedMemoryBus(bus_path)
    try:
        tasks, _ = build_role_tasks(
            role, bus, params, follower=follower, horizon=horizon,
            cmd_topic=cmd_topic, safety_stop=safety_stop,
        )
        sched = RateScheduler(tasks)
        return sched.run(duration, stop=lambda: _stop_requested(bus))
    finally:
        bus.close()


def _role_entry(role, bus_path, duration, follower, horizon, platform,
                cmd_topic="cmd_vel", safety_stop=0.25):
    """Child-process entry (module-level for the spawn pickler).

    The role's JAX platform is pinned HERE, before the child touches a
    backend, rather than inherited from the parent's environment. Only the
    follower may get an accelerator (see :func:`run_multiprocess`): a JAX
    process reserves most of a GPU's memory when it first uses it, so a
    second process on the same card fails for want of memory."""
    logging.basicConfig(level=logging.WARNING)
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    run_role(role, bus_path, duration, follower=follower, horizon=horizon,
             cmd_topic=cmd_topic, safety_stop=safety_stop)


def run_multiprocess(
    follower: str = "point",
    duration: float = 60.0,
    goal=(1.0, -1.0),
    start_pose=(-1.0, -1.0, 0.0),
    horizon: Optional[int] = 20,
    params: Optional[Params] = None,
    bus_path: Optional[str] = None,
    roles=("planner", "costmaps", "follower"),
    role_platform: str = "cpu",
    safety_stop: Optional[float] = None,
) -> dict:
    """Supervisor: spawn the compute roles as OS processes, run the world
    role here, stop everything once the follower latches the goal.

    ``role_platform`` pins the follower role's JAX backend (e.g. ``"gpu"``
    for the solver on a card; ``""`` inherits the ambient platform). Every
    other role runs on the CPU, so at most one process opens the card (see
    :func:`_role_entry`).
    ``safety_stop`` adds the safety role (its own OS process): the follower
    publishes cmd_vel_raw and the monitor gates to cmd_vel at this stop
    distance [m]; the supervisor surfaces its counters as stats["safety"].

    Returns the world role's rate stats plus ``goal_reached`` / ``final_pose``.
    """
    params = params or Params()
    if safety_stop is not None and "safety" not in roles:
        roles = tuple(roles) + ("safety",)
    cmd_topic = "cmd_vel_raw" if "safety" in roles else "cmd_vel"
    ctx = multiprocessing.get_context("spawn")  # never fork a live JAX runtime
    workdir = None
    if bus_path is None:
        shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
        workdir = tempfile.mkdtemp(prefix="jax_mpc_bus_", dir=shm_root)
        bus_path = os.path.join(workdir, "bus")

    bus = SharedMemoryBus(bus_path)  # parent creates & initializes the region
    procs = [
        ctx.Process(
            target=_role_entry,
            args=(role, bus_path, duration + 30.0, follower, horizon,
                  role_platform if role == "follower" else "cpu",
                  cmd_topic, safety_stop if safety_stop is not None else 0.25),
            name=f"jax-mpc-{role}",
            daemon=True,
        )
        for role in roles
    ]
    stats: dict = {}
    try:
        for p in procs:
            p.start()

        tasks, extras = build_role_tasks(
            "world", bus, params, start_pose=start_pose
        )
        sim = extras["sim"]
        publish_goal(bus, goal[0], goal[1])

        def stop():
            if bus.latest(STATUS_TOPIC)[0] == "goal_reached":
                return True
            # a crashed compute role can never reach the goal — don't burn
            # the whole duration discovering that
            return any(p.exitcode not in (None, 0) for p in procs)

        sched = RateScheduler(tasks)
        stats = sched.run(duration, stop=stop)
        stats["goal_reached"] = bus.latest(STATUS_TOPIC)[0] == "goal_reached"
        stats["final_pose"] = np.asarray(sim.pose, dtype=float)
        stats["failed_roles"] = [
            p.name for p in procs if p.exitcode not in (None, 0)
        ]
        if "safety" in roles:
            hb = bus.latest(SAFETY_STATUS_TOPIC)[0]
            # None heartbeat = the safety process never came up: the command
            # chain was severed (nothing forwarded cmd_vel_raw), so say so
            # instead of handing callers a silent None
            stats["safety"] = hb if hb is not None else {
                "blocked": 0, "passed": 0, "heartbeat_missing": True,
            }
    finally:
        try:
            bus.publish(SHUTDOWN_TOPIC, True)
        except Exception:
            pass
        deadline = time.monotonic() + 15.0
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        bus.close()
        if workdir is not None:
            try:
                os.unlink(bus_path)
                os.rmdir(workdir)
            except OSError:
                pass
    return stats


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--follower", default="point", choices=["point", "tracking"])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--goal", type=float, nargs=2, default=(1.0, -1.0))
    ap.add_argument(
        "--safety-stop", type=float, default=None, metavar="DIST",
        help="add the safety-monitor role (own OS process) gating cmd_vel",
    )
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    # Host deployment shape: every role on the CPU. The world role runs in
    # this supervisor process; children pin their own platform.
    import jax

    jax.config.update("jax_platforms", "cpu")
    stats = run_multiprocess(
        args.follower, args.duration, tuple(args.goal),
        safety_stop=args.safety_stop,
    )
    for name, s in stats.get("tasks", {}).items():
        log.info(
            "%-14s %5.1f Hz  runs=%-5d misses=%-3d max_late=%.3fs",
            name, s["rate_hz"], s["runs"], s["misses"], s["max_lateness_s"],
        )
    log.info(
        "goal_reached=%s pose=%s",
        stats.get("goal_reached"), np.round(stats.get("final_pose", np.full(3, np.nan)), 3),
    )
    raise SystemExit(0 if stats.get("goal_reached") else 1)


if __name__ == "__main__":
    main()
