"""Render the autonomous exploration run to docs/demo_exploration.png.

No human goal, no prior map: the mapper builds /map live, the explorer
publishes its own frontier goals, the safety monitor guards wall corners,
and the run terminates itself when no reachable frontier remains. Rendering:
white = mapped free, black = mapped wall, grey = never observed; the robot
trail shades red -> blue over time; green squares mark the self-chosen
frontier goals. Runs on CPU in ~2 min."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path="docs/demo_exploration.png"):
    from ros2_mpc_jax.nodes.explorer import ExplorerNode
    from ros2_mpc_jax.nodes.launch import build_sim_stack
    from ros2_mpc_jax.utils.viz import _write_png

    stack = build_sim_stack(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12,
        map_source="mapper", safety_stop=0.22,
    )
    explorer = ExplorerNode(stack.bus, stack.mapper, stack.params)
    trail, goals = [], []
    for _ in range(2500):
        e = explorer.tick()
        if e["status"] == "complete":
            break
        if e.get("goal") is not None and (not goals or not np.allclose(goals[-1], e["goal"])):
            goals.append(np.asarray(e["goal"]))
        out = stack.tick()
        trail.append(np.asarray(out["pose"][:2]))
    unknown = float((stack.mapper.occupancy() == -1).mean())
    print(f"goals={explorer.n_goals} abandoned={len(explorer.abandoned)} "
          f"blocked={stack.safety.n_blocked} unknown={unknown:.2f} ticks={len(trail)}")

    p = stack.mapper.probability()
    img = np.full(p.shape + (3,), 200, np.uint8)
    img[p < 0.35] = 255
    img[p > 0.65] = 20
    H = p.shape[0]
    res = stack.mapper.resolution
    org = stack.mapper.origin

    def px(xy):
        c = int((xy[0] - org[0]) / res)
        r = H - 1 - int((xy[1] - org[1]) / res)
        return np.clip(r, 0, H - 1), np.clip(c, 0, H - 1)

    T = len(trail)
    for k, xy in enumerate(trail):
        r, c = px(xy)
        frac = k / max(1, T - 1)
        img[r, c] = (int(200 * (1 - frac)), 40, int(220 * frac))
    for g in goals:
        r, c = px(g)
        img[max(0, r - 2):r + 3, max(0, c - 2):c + 3] = (0, 150, 0)
    _write_png(out_path, img)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
