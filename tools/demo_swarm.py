"""Render the antipodal-swap swarm demo to docs/demo_swarm.png: 8 robots on
a circle trade places through the center; the swept-neighbor obstacle costs
bend every crossing into a collision-free weave (parallel/fleet.py swarm
API). Runs on CPU in ~1 min."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path="docs/demo_swarm.png"):
    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.parallel import circle_swarm, make_swarm_rollout
    from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization
    from ros2_mpc_jax.utils.viz import _write_png

    P = Params()
    prob = make_point_stabilization(
        P, horizon=20, reference_parity=False,
        settings=SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6),
    )
    B = 8
    thetas, U0 = circle_swarm(prob, B=B, radius=2.0)
    roll = make_swarm_rollout(prob, n_ticks=400, dt=P.dt, k_neighbors=4, record=True)
    out = roll(thetas, U0)
    traj = np.asarray(out.trajectories)  # (T+1, B, 3)
    print(
        f"reach={float(out.reach_fraction):.2f} "
        f"min_sep={float(out.min_separation):.3f}"
    )

    # white canvas, 0.02 m/px, trajectories colored per robot
    res, margin = 0.02, 0.5
    lo = traj[..., :2].reshape(-1, 2).min(0) - margin
    hi = traj[..., :2].reshape(-1, 2).max(0) + margin
    w = int((hi[0] - lo[0]) / res) + 1
    h = int((hi[1] - lo[1]) / res) + 1
    rgb = np.full((h, w, 3), 255, dtype=np.uint8)

    def px(xy):
        col = ((xy[:, 0] - lo[0]) / res).astype(int)
        row = h - 1 - ((xy[:, 1] - lo[1]) / res).astype(int)
        return np.clip(row, 0, h - 1), np.clip(col, 0, w - 1)

    hues = np.linspace(0, 1, B, endpoint=False)
    colors = (
        np.stack(
            [
                np.abs(hues * 6 - 3) - 1,
                2 - np.abs(hues * 6 - 2),
                2 - np.abs(hues * 6 - 4),
            ],
            axis=1,
        ).clip(0, 1)
        * 200
    ).astype(np.uint8)

    for b in range(B):
        r, c = px(traj[:, b, :2])
        for dr in (0, 1):
            for dc in (0, 1):
                rgb[np.clip(r + dr, 0, h - 1), np.clip(c + dc, 0, w - 1)] = colors[b]
    # start (filled square) and goal (hollow-ish bigger square) markers
    goals = np.asarray(thetas["goal"])[:, :2]
    for b in range(B):
        r, c = px(traj[:1, b, :2])
        rgb[max(r[0] - 3, 0) : r[0] + 4, max(c[0] - 3, 0) : c[0] + 4] = colors[b] // 2
        r, c = px(goals[b : b + 1])
        rgb[max(r[0] - 4, 0) : r[0] + 5, max(c[0] - 4, 0) : c[0] + 5] = colors[b]
        rgb[max(r[0] - 2, 0) : r[0] + 3, max(c[0] - 2, 0) : c[0] + 3] = (255, 255, 255)

    _write_png(out_path, rgb)
    print(f"wrote {out_path} ({w}x{h})")


if __name__ == "__main__":
    main(*sys.argv[1:])
