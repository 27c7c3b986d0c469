"""Drop-in API compatibility: reference signatures, shapes, and layouts."""

import numpy as np
import pytest

from ros2_mpc_jax.compat import (
    LegacyPointStabilizationMpc,
    PointStabilizationMpc,
    SolveError,
    TrackingMpc,
)
from ros2_mpc_jax.config import Params

N = 10


def test_tracking_mpc_reference_signature():
    mpc = TrackingMpc(Params(), horizon=N)
    assert (mpc.N, mpc.n_states, mpc.n_controls, mpc.dt) == (N, 3, 2, 0.2)
    u0 = np.zeros((mpc.n_controls, mpc.N))  # reference layout (path_follower:186)
    x0 = np.array([0.0, 0.0, 0.0])
    ts = np.arange(1, N + 1) * mpc.dt
    pf = np.stack([0.15 * ts, np.zeros(N), np.zeros(N)], axis=1).flatten().reshape(-1, 1)
    puf = np.tile([0.15, 0.0], (N, 1)).flatten().reshape(-1, 1)
    x_opt, u_first = mpc.perform_mpc(u0, x0, pf, puf)
    assert x_opt.shape == (3, N + 1)  # CasADi sol.value(X) layout
    assert u_first.shape == (2,)
    assert u_first[0] > 0.1  # drives forward along the reference


def test_point_stab_mpc_reference_signature():
    mpc = PointStabilizationMpc(Params(), horizon=N)
    u0 = np.zeros((mpc.n_controls, mpc.N))
    u_first = mpc.perform_mpc(u0, initial_state=np.array([0, 0, 0.0]),
                              final_state=np.array([1.0, 0.0, 0.0]))
    assert u_first.shape == (2,)
    assert u_first[0] > 0.05  # drives toward the goal
    # default bounds honored
    assert -0.05 - 1e-6 <= u_first[0] <= 0.15 + 1e-6


def test_legacy_mpc_returns_full_trajectories():
    mpc = LegacyPointStabilizationMpc(Params(), horizon=N)
    u0 = np.zeros((2, N))
    x_opt, u_opt = mpc.perform_mpc(u0, np.array([0, 0, 0.0]), np.array([1.0, 0.0, 0.0]))
    assert x_opt.shape == (3, N + 1)
    assert u_opt.shape == (2, N)


def test_strict_mode_raises_on_nonconvergence():
    mpc = PointStabilizationMpc(Params(), horizon=N, strict=True)
    with pytest.raises(SolveError):
        # NaN input cannot converge
        mpc.perform_mpc(np.zeros((2, N)), np.array([np.nan, 0, 0]), np.array([1, 0, 0.0]))
