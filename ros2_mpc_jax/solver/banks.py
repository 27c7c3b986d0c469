"""Seed-pinned scenario banks of the benchmark and the GPU smoke test.

BASELINE.json config 4 is a 4096-scenario N=20 point-stabilization bank per
device. Two variants share one geometry (start poses near the origin, goals
within 1.5 m, rng seed 0): the *inert* bank in the reference's parity
formulation (dead obstacle cost, quirk #1) and the *corrected* bank, whose
live Gaussian obstacle cost sees three points clustered near each
scenario's start-goal line (local_planner_point_stabilization.py:60-67 made
live). The tracking bank follows straight reference lines at 0.05-0.2 m/s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def point_stab_banks(prob, prob_c, B: int, seed: int = 0) -> dict:
    """The inert bank (``prob``, parity) and the corrected bank (``prob_c``,
    obstacle-active) on one geometry. Returns ``{"thetas", "thetas_c",
    "U0", "obs_x", "obs_y"}`` (obstacle coordinates as NumPy, padded with the
    100 m far sentinel)."""
    N = prob.ocp.horizon
    n_obs = prob_c.make_theta(np.zeros(3), np.zeros(3))["obs_x"].shape[0]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.5, 1.5, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    obs_x = np.full((B, n_obs), 100.0)
    obs_y = np.full((B, n_obs), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    for j in range(3):
        # Keep clusters off both the start and goal inflation discs — an
        # obstacle core *on* the goal is a contradictory task, not a solver
        # workload (same rule as tests/test_oracle_sweep.py). Rejection-
        # resample the violating rows (a fixed shift can land right back
        # inside a disc).
        pts = mid + rng.uniform(-0.4, 0.4, size=(B, 2))
        for _ in range(16):
            d = np.minimum(
                np.linalg.norm(pts - x0[:, :2], axis=1),
                np.linalg.norm(pts - goal[:, :2], axis=1),
            )
            bad = d < 0.3
            if not bad.any():
                break
            pts[bad] = mid[bad] + rng.uniform(-0.45, 0.45, size=(int(bad.sum()), 2))
        else:
            pts[bad] = 100.0  # park irredeemable rows (start ~ goal) far away
        obs_x[:, j] = pts[:, 0]
        obs_y[:, j] = pts[:, 1]
    return {
        "thetas": jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal)),
        "thetas_c": jax.vmap(prob_c.make_theta)(
            jnp.asarray(x0), jnp.asarray(goal), jnp.asarray(obs_x), jnp.asarray(obs_y)
        ),
        "U0": jnp.zeros((B, N, 2)),
        "obs_x": obs_x,
        "obs_y": obs_y,
    }


def tracking_bank(prob, B: int, dt: float, seed: int = 1):
    """(thetas, U0): robots near the origin following straight x-axis
    reference lines at per-scenario speeds in [0.05, 0.2] m/s."""
    N = prob.ocp.horizon
    rng = np.random.default_rng(seed)
    ts = (np.arange(1, N + 1) * dt)[None, :, None]
    speed = rng.uniform(0.05, 0.2, size=(B, 1, 1))
    x_ref = np.concatenate([speed * ts, np.zeros((B, N, 2))], axis=2)
    u_ref = np.concatenate(
        [np.broadcast_to(speed, (B, N, 1)), np.zeros((B, N, 1))], axis=2
    )
    thetas = jax.vmap(prob.make_theta)(
        jnp.asarray(rng.uniform(-0.1, 0.1, size=(B, 3))),
        jnp.asarray(x_ref),
        jnp.asarray(u_ref),
    )
    return thetas, jnp.zeros((B, N, 2))
