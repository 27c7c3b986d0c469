"""Render the on-device occupancy mapper's reconstruction to
docs/demo_mapping.png: drive three goals through the synthetic world while
fusing every scan into the log-odds grid (ops/mapping.py), then write
p(occupied) as white=free / black=wall / grey=never-observed. The reference
cannot build maps at all — it ships a cartographer artifact. Runs on CPU
in ~1 min."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path="docs/demo_mapping.png"):
    from ros2_mpc_jax.nodes.launch import build_sim_stack
    from ros2_mpc_jax.nodes.mapper import MapperNode
    from ros2_mpc_jax.utils.viz import _write_png

    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12)
    mapper = MapperNode(stack.bus, stack.params, size_m=6.0, resolution=0.05)
    for g in [(0.4, -1.6), (-1.2, -1.0), (1.0, -1.0)]:
        stack.publish_goal(*g)
        for _ in range(250):
            out = stack.tick()
            mapper.tick()
            if out["control"].get("status") == "goal_reached":
                break
    mapper.publish()
    p = mapper.probability()
    img = np.full(p.shape + (3,), 200, np.uint8)  # unknown: grey
    img[p < 0.35] = 255                           # free: white
    img[p > 0.65] = 20                            # occupied: black
    _write_png(out_path, img)
    print(f"{mapper.n_scans} scans fused; wrote {out_path}")


if __name__ == "__main__":
    main()
