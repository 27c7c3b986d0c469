"""Render the multi-start basin-escape demo to docs/demo_escape.png.

The canonical local-method failure: an obstacle dead-center on the
start-goal line. The cost gradient is symmetric in y, so the plain
interior-point iLQR (and the reference's IPOPT, which would raise and kill
its node on failure — ros2_mpc/planner/local_planner_tracking.py:74) can
never break the tie: it rolls up to the obstacle and hovers. Pure sampling
(MPPI) cannot bridge it either — its exploration variance is far smaller
than the goal distance. The multi-start engine
(solver/mppi.py::make_multistart_solver) polishes deterministic arc seeds
alongside the warm start and the MPPI elite in ONE batched iLQR call and
takes the best (converged, cost): it swings around the obstacle and reaches
the goal at ~28% lower cost. Runs on CPU in ~1 min.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOAL = np.array([1.0, 0.0, 0.0])
OBST = np.array([0.5, 0.0])


def solve_scenario():
    import jax
    import jax.numpy as jnp

    from ros2_mpc_jax.config import Params
    from ros2_mpc_jax.solver import (
        MppiSettings,
        make_multistart_solver,
        make_point_stabilization,
    )

    P = Params()
    prob = make_point_stabilization(horizon=40, reference_parity=False)
    n = P.n_obstacle_points
    obs_x = np.full(n, 100.0)
    obs_y = np.full(n, 100.0)
    obs_x[0], obs_y[0] = OBST
    theta = prob.make_theta(
        jnp.zeros(3), jnp.asarray(GOAL), jnp.asarray(obs_x), jnp.asarray(obs_y)
    )
    # goal weight is a runtime theta leaf; the demo wants reaching to pay
    # (the reference default Q=(1,1,.005) makes hovering near-optimal)
    theta["Q"] = jnp.array([5.0, 5.0, 0.05])

    sol_p = jax.jit(prob.solve)(theta, prob.default_u0)
    ms = jax.jit(make_multistart_solver(
        prob.ocp, prob.settings, MppiSettings(n_samples=128, n_iters=8)
    ))
    sol_m = ms(theta, prob.default_u0, jax.random.PRNGKey(0))

    for name, s in (("plain iLQR", sol_p), ("multistart", sol_m)):
        X = np.asarray(s.X)
        print(
            f"{name:>10}: cost={float(s.cost):7.2f} converged={bool(s.converged)} "
            f"min_goal_dist={np.linalg.norm(X[:, :2] - GOAL[:2], axis=1).min():.3f} m "
            f"obstacle_clearance={np.hypot(X[:, 0] - OBST[0], X[:, 1] - OBST[1]).min():.3f} m"
        )
    return np.asarray(sol_p.X), np.asarray(sol_m.X), float(sol_p.cost), float(sol_m.cost)


def main(out_path="docs/demo_escape.png"):
    from ros2_mpc_jax.utils.viz import _write_png

    X_p, X_m, c_p, c_m = solve_scenario()

    pts = np.concatenate([X_p[:, :2], X_m[:, :2], OBST[None], GOAL[None, :2]], axis=0)
    res, margin = 0.005, 0.2
    lo = pts.min(0) - margin
    hi = pts.max(0) + margin
    w = int((hi[0] - lo[0]) / res) + 1
    h = int((hi[1] - lo[1]) / res) + 1
    rgb = np.full((h, w, 3), 255, dtype=np.uint8)

    def px(xy):
        xy = np.atleast_2d(xy)
        col = ((xy[:, 0] - lo[0]) / res).astype(int)
        row = h - 1 - ((xy[:, 1] - lo[1]) / res).astype(int)
        return np.clip(row, 0, h - 1), np.clip(col, 0, w - 1)

    def stamp(xy, color, size):
        r, c = px(xy)
        for dr in range(-size, size + 1):
            for dc in range(-size, size + 1):
                rgb[np.clip(r + dr, 0, h - 1), np.clip(c + dc, 0, w - 1)] = color

    # obstacle influence disc (inflation radius), then core
    rr, cc = np.mgrid[0:h, 0:w]
    wx = lo[0] + cc * res
    wy = lo[1] + (h - 1 - rr) * res
    rgb[np.hypot(wx - OBST[0], wy - OBST[1]) < 0.2] = (250, 220, 220)
    stamp(OBST, (40, 40, 40), 4)

    stamp([0.0, 0.0], (0, 0, 0), 4)      # start: black
    stamp(GOAL[:2], (0, 140, 0), 4)      # goal: green
    for X, color in ((X_p, (200, 30, 30)), (X_m, (30, 60, 200))):
        for k in range(len(X)):
            stamp(X[k, :2], color, 1)

    _write_png(out_path, rgb)
    print(
        f"wrote {out_path} ({w}x{h}); red=plain iLQR hovers at the saddle "
        f"(cost {c_p:.1f}), blue=multistart escapes (cost {c_m:.1f}, "
        f"{(1 - c_m / c_p) * 100:.0f}% lower)"
    )


if __name__ == "__main__":
    main()
