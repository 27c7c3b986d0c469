"""Shared-memory bus (native/shm_bus.cpp + nodes/shm_bus.py): the
multi-process transport replacing the reference's DDS layer, and the
multi-process node graph built on it (nodes/multiproc.py)."""

import multiprocessing
import os
import tempfile
import threading

import numpy as np
import pytest

from ros2_mpc_jax.nodes.bus import Transform, Twist
from ros2_mpc_jax.nodes.shm_bus import SharedMemoryBus, load


def _bus_path():
    shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    d = tempfile.mkdtemp(prefix="shmbus_test_", dir=shm_root)
    return os.path.join(d, "bus")


pytestmark = pytest.mark.skipif(load() is None, reason="native shm bus unavailable (no g++)")


def test_roundtrip_versions_and_tf():
    path = _bus_path()
    a = SharedMemoryBus(path)
    b = SharedMemoryBus(path)
    try:
        assert a.latest("/x") == (None, 0)
        v1 = a.publish("/x", {"arr": np.arange(7), "s": "hello"})
        msg, ver = b.latest("/x")
        assert v1 == ver == 1
        assert np.array_equal(msg["arr"], np.arange(7)) and msg["s"] == "hello"
        v2 = a.publish("/x", Twist(0.1, -0.2))
        assert v2 == 2
        msg, ver = b.latest("/x")
        assert ver == 2 and msg.linear_x == 0.1

        a.set_transform("map", "odom", Transform(x=1.5, y=-0.5))
        tf = b.lookup_transform("map", "odom")
        assert (tf.x, tf.y) == (1.5, -0.5)
        assert b.lookup_transform("map", "nowhere") is None

        b.subscribe("/x")
        b.subscribe("/x")
        assert a.subscription_count("/x") == 2
    finally:
        a.close()
        b.close()
        os.unlink(path)


def test_callbacks_spin_once_exactly_once():
    """spin_once delivers each version at most once; local publishes deliver
    synchronously (in-process bus semantics) without re-delivery on spin."""
    path = _bus_path()
    a = SharedMemoryBus(path)
    b = SharedMemoryBus(path)
    try:
        got = []
        b.subscribe("/t", got.append)
        a.publish("/t", 1)
        a.publish("/t", 2)  # mailbox semantics: only the latest is seen
        assert b.spin_once() == 1 and got == [2]
        assert b.spin_once() == 0

        local = []
        b.subscribe("/u", local.append)
        b.publish("/u", "mine")
        assert local == ["mine"]
        assert b.spin_once() == 0  # own publish must not double-deliver
    finally:
        a.close()
        b.close()
        os.unlink(path)


def test_slot_overflow_raises():
    path = _bus_path()
    a = SharedMemoryBus(path, slot_bytes=4096)
    try:
        with pytest.raises(ValueError, match="slot_bytes"):
            a.publish("/big", np.zeros(10_000))
    finally:
        a.close()
        os.unlink(path)


def test_seqlock_no_torn_reads():
    """A writer hammering one topic must never let a reader observe a mix of
    two versions (the seqlock retry contract)."""
    path = _bus_path()
    w = SharedMemoryBus(path)
    r = SharedMemoryBus(path)
    stop = threading.Event()
    torn = []

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            w.publish("/h", np.full(4096, k % 251, dtype=np.int64))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        seen = 0
        for _ in range(3000):
            msg, ver = r.latest("/h")
            if msg is None:
                continue
            seen += 1
            if not np.all(msg == msg[0]):
                torn.append(ver)
        assert seen > 100
        assert torn == []
    finally:
        stop.set()
        t.join(timeout=5)
        w.close()
        r.close()
        os.unlink(path)


def _child_publisher(path, n):
    bus = SharedMemoryBus(path)
    for k in range(1, n + 1):
        bus.publish("/cross", {"k": k, "payload": np.arange(k, dtype=np.float64)})
    bus.publish("/done", True)
    bus.close()


def test_cross_process_delivery():
    """Messages published by another OS process arrive by value with
    monotonically increasing versions."""
    path = _bus_path()
    bus = SharedMemoryBus(path)
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_child_publisher, args=(path, 50))
    p.start()
    try:
        p.join(timeout=60)
        assert p.exitcode == 0
        assert bus.latest("/done")[0] is True
        msg, ver = bus.latest("/cross")
        assert ver == 50 and msg["k"] == 50
        assert np.array_equal(msg["payload"], np.arange(50, dtype=np.float64))
    finally:
        if p.is_alive():
            p.terminate()
        bus.close()
        os.unlink(path)


@pytest.mark.slow
def test_multiprocess_nav_reaches_goal():
    """The reference's deployment topology — separate OS processes for the
    planner, costmaps, and MPC follower (launch_all.launch.py:8-64) — rebuilt
    over the shared-memory bus: the robot must still reach the goal with
    every topic crossing a process boundary."""
    from ros2_mpc_jax.nodes.multiproc import run_multiprocess

    stats = run_multiprocess(follower="point", duration=120.0, horizon=12)
    assert stats["goal_reached"], stats
    pose = stats["final_pose"]
    assert np.linalg.norm(pose[:2] - np.array([1.0, -1.0])) < 0.35
    # the world role held its rates while the compute roles ran elsewhere
    assert stats["tasks"]["robot_state"]["runs"] > 0
    assert stats["tasks"]["lidar"]["runs"] > 0


@pytest.mark.slow
def test_multiprocess_with_safety_role():
    """The safety monitor as its OWN OS process on the shm bus: the follower
    publishes cmd_vel_raw, the monitor process gates to cmd_vel, and the
    robot still reaches the goal on a clear route (guard transparent); the
    supervisor surfaces the monitor's counters over the bus heartbeat."""
    from ros2_mpc_jax.nodes.multiproc import run_multiprocess

    stats = run_multiprocess(
        follower="point", duration=150.0, horizon=12, safety_stop=0.2
    )
    assert stats["goal_reached"], stats
    assert stats["failed_roles"] == []
    safety = stats.get("safety")
    assert safety is not None and safety["passed"] > 0
    # every forwarded command crossed two process boundaries (follower ->
    # monitor -> world); on the clear route nothing should be blocked
    assert safety["blocked"] == 0
