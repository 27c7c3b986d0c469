"""Bag record/replay (nodes/bag.py): the rosbag-analogue forensic tool the
reference lacks entirely. A recorded run must round-trip through disk, and a
sensor-only replay must drive a live node to bit-identical outputs."""

import numpy as np

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.nodes.bag import BagRecorder, load_bag, replay, save_bag
from ros2_mpc_jax.nodes.bus import MessageBus
from ros2_mpc_jax.nodes.costmap_nodes import LocalCostmapNode
from ros2_mpc_jax.nodes.launch import build_sim_stack


def _record_run(n_ticks=30):
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=8)
    rec = BagRecorder(stack.bus)
    stack.publish_goal(0.4, -1.6)
    for _ in range(n_ticks):
        stack.tick()
    return stack, rec.stop()


def test_bag_records_all_live_topics():
    _, records = _record_run(n_ticks=10)
    topics = {r.topic for r in records}
    for expected in ("/scan", "/robot_position", "cmd_vel", "/my_local_costmap",
                     "/goal_pose"):
        assert expected in topics, f"{expected} missing from {sorted(topics)}"
    # capture order is preserved and timestamps are monotone
    ts = [r.t for r in records]
    assert ts == sorted(ts)


def test_bag_save_load_roundtrip(tmp_path):
    _, records = _record_run(n_ticks=8)
    p = tmp_path / "run.bag"
    save_bag(str(p), records)
    loaded = load_bag(str(p))
    assert len(loaded) == len(records)
    for a, b in zip(records, loaded):
        assert a.topic == b.topic and a.seq == b.seq and a.t == b.t
    # payload fidelity on an array-carrying message
    scans_a = [r.msg.ranges for r in records if r.topic == "/scan"]
    scans_b = [r.msg.ranges for r in loaded if r.topic == "/scan"]
    for sa, sb in zip(scans_a, scans_b):
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))


def test_sensor_replay_reproduces_costmaps_bitwise():
    """Replay only the recorded SENSOR stream into a fresh bus and run a
    fresh LocalCostmapNode in lockstep after every scan: its outputs must
    equal the costmaps the original run published, byte for byte."""
    _, records = _record_run(n_ticks=20)
    originals = [np.asarray(r.msg.data) for r in records if r.topic == "/my_local_costmap"]
    assert len(originals) >= 5

    bus2 = MessageBus()
    node = LocalCostmapNode(bus2, Params())
    reproduced = []

    def on_record(rec):
        # the original graph ticks the costmap once per sim tick, i.e. once
        # per published scan, after the matching odometry is out
        if rec.topic == "/scan":
            out = node.tick()
            if out.get("status", "ok").startswith("waiting"):
                return
            msg, _ = bus2.latest("/my_local_costmap")
            reproduced.append(np.asarray(msg.data))

    n = replay(bus2, records, topics=("/scan", "/robot_position"), on_record=on_record)
    assert n > 0
    # Alignment: the sim graph ticks the costmap at the START of tick k+1 on
    # the scan sim.step() published at the END of tick k, and the very first
    # costmap consumed the priming scan published before the recorder
    # attached — so reproduced[i] (from recorded scan i) corresponds to
    # originals[i+1].
    assert len(reproduced) >= len(originals) - 1
    pairs = list(zip(originals[1:], reproduced))
    assert len(pairs) >= 5
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)


def test_replay_filters_topics():
    _, records = _record_run(n_ticks=6)
    bus2 = MessageBus()
    replay(bus2, records, topics=("/scan",))
    assert bus2.latest("/scan")[0] is not None
    assert bus2.latest("cmd_vel")[0] is None


def test_bag_cli_info_and_offline_viz(tmp_path, capsys):
    import os

    from ros2_mpc_jax.nodes import bag as bagmod

    _, records = _record_run(n_ticks=10)
    p = tmp_path / "run.bag"
    save_bag(str(p), records)

    bagmod.main(["info", str(p)])
    out = capsys.readouterr().out
    assert "/scan" in out and "records over" in out

    viz_dir = tmp_path / "viz"
    bagmod.main(["replay", str(p), "--viz", str(viz_dir)])
    out = capsys.readouterr().out
    assert "replayed" in out
    assert os.path.exists(viz_dir / "latest.png")
