"""Render the moving-pedestrian dodge to docs/demo_pedestrian.png.

A 0.15 m pedestrian patrols across the robot's straight line to the goal
(oscillating along x = 0.2); the corrected stack sees it only through the
lidar (it is in no map) and detours around the moving body — live
scan-derived obstacle costs + scan-aware replanning. The reference cannot
react to it at all (dead obstacle costs, scan-blind planner). Runs on CPU
in ~1 min.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path="docs/demo_pedestrian.png"):
    from ros2_mpc_jax.nodes.launch import build_sim_stack
    from ros2_mpc_jax.utils.viz import _write_png

    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=16)
    params = stack.params
    tick = {"i": 0}

    def ped_pos():
        t = tick["i"] * params.dt
        return [(0.2, -1.1 + 0.35 * np.sin(2 * np.pi * t / 12.0))]

    stack.sim.moving_obstacles = ped_pos
    stack.publish_goal(1.0, -1.0)
    robot_trail, ped_trail = [], []
    min_sep = np.inf
    for i in range(400):
        tick["i"] = i
        out = stack.tick()
        p = np.asarray(out["pose"][:2])
        c = np.asarray(ped_pos()[0])
        robot_trail.append(p)
        ped_trail.append(c)
        min_sep = min(min_sep, float(np.linalg.norm(p - c)))
        if out["control"].get("status") == "goal_reached":
            break
    robot_trail = np.asarray(robot_trail)
    ped_trail = np.asarray(ped_trail)
    print(f"reached in {len(robot_trail)} ticks, min separation {min_sep:.2f} m")

    # render: map walls + both trails (pedestrian grey, robot color-graded by time)
    img = stack.sim.map_image
    info = stack.sim.map_info
    res = float(info["resolution"])
    ox, oy = info["origin"][:2]
    H, W = img.shape
    rgb = np.full((H, W, 3), 255, np.uint8)
    rgb[img == 0] = (30, 30, 30)

    def px(xy):
        col = int((xy[0] - ox) / res)
        row = H - 1 - int((xy[1] - oy) / res)
        return np.clip(row, 0, H - 1), np.clip(col, 0, W - 1)

    def stamp(xy, color, size=1):
        r, c = px(xy)
        rgb[max(0, r - size):r + size + 1, max(0, c - size):c + size + 1] = color

    T = len(robot_trail)
    for k in range(T):
        frac = k / max(1, T - 1)
        stamp(ped_trail[k], (160, 160, 160))
        # robot trail shades red -> blue over time so the dodge reads as motion
        stamp(robot_trail[k], (int(200 * (1 - frac)), 40, int(220 * frac)))
    stamp(robot_trail[0], (0, 0, 0), 2)
    stamp((1.0, -1.0), (0, 140, 0), 2)
    _write_png(out_path, rgb)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
