"""Cost-term unit tests against straightforward NumPy reimplementations."""

import jax.numpy as jnp
import numpy as np

from ros2_mpc_jax.ops import costs


def test_quadratic_error():
    e = jnp.array([0.3, -0.2, 0.5])
    w = jnp.array([1.0, 1.0, 0.005])
    expected = 0.3**2 + 0.2**2 + 0.005 * 0.5**2
    np.testing.assert_allclose(float(costs.quadratic_error(e, w)), expected, rtol=1e-6)


def test_reverse_penalty_matches_reference_form():
    """(1/exp(v))**factor == exp(-factor*v), local_planner_tracking.py:124."""
    u = jnp.array([0.12, -0.3])
    for factor in [0.5, 5.0]:
        ref = (1.0 / np.exp(0.12)) ** factor
        np.testing.assert_allclose(float(costs.reverse_penalty(u, factor)), ref, rtol=1e-6)


def test_gaussian_obstacle_cost():
    rng = np.random.default_rng(0)
    ox = rng.uniform(-2, 2, size=160)
    oy = rng.uniform(-2, 2, size=160)
    xy = np.array([0.3, -0.4])
    ir, gain = 0.2, 5.0
    expected = gain * np.sum(np.exp(-((xy[0] - ox) ** 2 + (xy[1] - oy) ** 2) / ir**2))
    got = costs.gaussian_obstacle_cost(jnp.asarray(xy), jnp.asarray(ox), jnp.asarray(oy), ir, gain)
    np.testing.assert_allclose(float(got), expected, rtol=1e-5)


def test_barrier_obstacle_cost_matches_reference_algebra():
    """exp(exp(-hxy)*g) with hxy=log(r^2/ir^2) equals exp(g*ir^2/r^2),
    mpc_point_stabilization.py:46-53."""
    ox = np.array([1.0, -0.5])
    oy = np.array([0.5, 1.5])
    xy = np.array([0.0, 0.0])
    ir, gain = 0.2, 0.5
    hxy = np.log(((xy[0] - ox) / ir) ** 2 + ((xy[1] - oy) / ir) ** 2)
    expected = np.sum(np.exp(np.exp(-hxy) * gain))
    got = costs.barrier_obstacle_cost(jnp.asarray(xy), jnp.asarray(ox), jnp.asarray(oy), ir, gain)
    np.testing.assert_allclose(float(got), expected, rtol=1e-5)


def test_obstacle_costs_batch_over_stages():
    ox = jnp.linspace(-1, 1, 160)
    oy = jnp.linspace(-1, 1, 160)
    XY = jnp.stack([jnp.linspace(0, 1, 21), jnp.linspace(0, -1, 21)], axis=-1)
    out = costs.gaussian_obstacle_cost(XY, ox, oy, 0.2, 5.0)
    assert out.shape == (21,)
    single = costs.gaussian_obstacle_cost(XY[4], ox, oy, 0.2, 5.0)
    np.testing.assert_allclose(float(out[4]), float(single), rtol=1e-6)
