"""End-to-end navigation demo: run the full stack in simulation and render
the world + global plan + robot trace to a PNG (docs/demo_nav.png) — the
headless equivalent of watching the reference in RViz."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(follower="tracking", goal=(1.0, -1.0), out=None):
    # The demo is a host-side closed loop; CPU is the right backend unless
    # the caller explicitly pinned something else.
    if not os.environ.get("JAX_PLATFORMS"):
        os.environ["JAX_PLATFORMS"] = "cpu"
    from ros2_mpc_jax.nodes.launch import build_sim_stack
    from ros2_mpc_jax.utils import viz

    out = out or os.path.join(REPO, "docs", "demo_nav.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    stack = build_sim_stack(follower=follower, start_pose=(-1.0, -1.0, 0.0), horizon=12)
    stack.publish_goal(*goal)
    trace = [np.asarray(stack.sim.pose)]
    status = "start"
    for _ in range(300):
        o = stack.tick()
        trace.append(o["pose"])
        status = o["control"].get("status", status)
        if status == "goal_reached":
            break
    path_xy, _ = stack.follower.robot_controller.get_path()
    viz.render_world(
        stack.sim.map_image,
        stack.sim.map_info,
        robot_trace=np.asarray(trace),
        path_xy=path_xy,
        goal_xy=goal,
        out_path=out,
    )
    print(f"status={status} ticks={len(trace)-1} final={np.round(trace[-1],3)} -> {out}")
    return status == "goal_reached"


if __name__ == "__main__":
    ok = main(*(sys.argv[1:2] or ["tracking"]))
    sys.exit(0 if ok else 1)
