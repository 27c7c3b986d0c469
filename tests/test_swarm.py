"""On-device multi-robot swarm rollouts (parallel/fleet.py swarm API): mutual
avoidance through live obstacle costs, single jit, sharded variant with
per-tick position/velocity all_gathers over the mesh."""

import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.parallel import (
    circle_swarm,
    make_mesh,
    make_sharded_swarm_rollout,
    make_swarm_rollout,
    shard_bank,
)
from ros2_mpc_jax.solver import SolverSettings, make_point_stabilization

PARAMS = Params()
SETTINGS = SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)


def _problem(horizon=20):
    return make_point_stabilization(
        PARAMS, horizon=horizon, settings=SETTINGS, reference_parity=False
    )


@pytest.mark.slow
def test_swarm_antipodal_swap_reaches_with_separation():
    """The canonical swap: 8 robots on a circle trade places through the
    center. With the swept-neighbor obstacle costs every robot must reach
    its goal AND the fleet must keep real separation throughout; the parity
    formulation (dead obstacle cost, quirk #1) on the same scenario drives
    straight through — the contrast pins that avoidance is live."""
    import jax

    prob = _problem()
    thetas, U0 = circle_swarm(prob, B=8, radius=2.0)
    roll = make_swarm_rollout(prob, n_ticks=400, dt=PARAMS.dt, k_neighbors=4, record=True)
    out = roll(thetas, U0)
    assert float(out.reach_fraction) >= 0.99, float(out.reach_fraction)
    assert float(out.min_separation) > 0.25, float(out.min_separation)
    traj = np.asarray(out.trajectories)
    assert traj.shape == (401, 8, 3) and np.all(np.isfinite(traj))

    prob_parity = make_point_stabilization(PARAMS, horizon=20, settings=SETTINGS)
    thetas_p, _ = circle_swarm(prob_parity, B=8, radius=2.0)
    out_p = make_swarm_rollout(
        prob_parity, n_ticks=400, dt=PARAMS.dt, k_neighbors=4,
        avoidance_weight=None,  # keep the parity bank's dead weight
    )(thetas_p, U0)
    assert float(out_p.min_separation) < 0.1  # drives straight through
    del jax


def test_swarm_validates_slots_and_fleet_size():
    prob = _problem(horizon=6)
    thetas, U0 = circle_swarm(prob, B=4, radius=1.0)
    with pytest.raises(ValueError, match="fleet size"):
        make_swarm_rollout(prob, n_ticks=2, dt=PARAMS.dt, k_neighbors=4)(thetas, U0)
    with pytest.raises(ValueError, match="obstacle slots"):
        make_swarm_rollout(
            prob, n_ticks=2, dt=PARAMS.dt, k_neighbors=2,
            predict_taus=tuple(0.1 * i for i in range(200)),
        )(thetas, U0)


def test_sharded_swarm_matches_unsharded():
    """The mesh-sharded swarm (per-tick all_gather of positions/velocities
    over the robot axis) must reproduce the single-device rollout exactly —
    the collective changes where the neighbor search runs, not its result."""
    prob = _problem(horizon=8)
    B = 16
    thetas, U0 = circle_swarm(prob, B=B, radius=1.5)
    n_ticks = 12

    plain = make_swarm_rollout(prob, n_ticks, PARAMS.dt, k_neighbors=3)
    res_plain = plain(thetas, U0)

    mesh = make_mesh()
    sharded = make_sharded_swarm_rollout(prob, mesh, n_ticks, PARAMS.dt, k_neighbors=3)
    res_shard = sharded(shard_bank(thetas, mesh), shard_bank(U0, mesh))

    np.testing.assert_allclose(
        np.asarray(res_shard.final_states), np.asarray(res_plain.final_states), atol=1e-5
    )
    np.testing.assert_allclose(
        float(res_shard.min_separation), float(res_plain.min_separation), atol=1e-5
    )
    assert len(res_shard.final_states.sharding.device_set) == 8
