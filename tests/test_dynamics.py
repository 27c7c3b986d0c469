"""Unit tests for the unicycle model and integrators.

Strategy per SURVEY.md §4: analytic closed-form circular-arc motion is the
ground truth (the reference has no tests at all; this is layer 1 of the build
plan, SURVEY.md §7)."""

import jax
import jax.numpy as jnp
import numpy as np

from ros2_mpc_jax.models import unicycle
from ros2_mpc_jax.ops import integrators


def analytic_arc(x0, v, w, t):
    """Exact unicycle motion under constant (v, w)."""
    x, y, th = x0
    if abs(w) < 1e-12:
        return np.array([x + v * t * np.cos(th), y + v * t * np.sin(th), th])
    return np.array(
        [
            x + v / w * (np.sin(th + w * t) - np.sin(th)),
            y - v / w * (np.cos(th + w * t) - np.cos(th)),
            th + w * t,
        ]
    )


def test_dynamics_values():
    x = jnp.array([1.0, 2.0, jnp.pi / 3])
    u = jnp.array([0.5, -0.2])
    dx = unicycle.f(x, u)
    np.testing.assert_allclose(
        np.asarray(dx),
        [0.5 * np.cos(np.pi / 3), 0.5 * np.sin(np.pi / 3), -0.2],
        rtol=1e-6,
    )


def test_dynamics_batched():
    xs = jnp.zeros((7, 3)).at[:, 2].set(jnp.linspace(0, 1, 7))
    us = jnp.ones((7, 2))
    out = unicycle.f(xs, us)
    assert out.shape == (7, 3)
    one = unicycle.f(xs[3], us[3])
    np.testing.assert_allclose(np.asarray(out[3]), np.asarray(one), rtol=1e-6)


def test_rk4_matches_analytic_arc():
    x0 = np.array([0.2, -0.1, 0.4])
    v, w, dt = 0.15, 0.18, 0.2
    F = integrators.make_step(unicycle.f, "rk4", dt)
    X = integrators.rollout(F, jnp.asarray(x0), jnp.tile(jnp.array([v, w]), (30, 1)))
    for k in [1, 10, 30]:
        np.testing.assert_allclose(
            np.asarray(X[k]), analytic_arc(x0, v, w, k * dt), atol=5e-6
        )


def test_euler_first_order_error():
    """Euler error should shrink linearly with dt (it is the reference's
    tracking integrator, local_planner_tracking.py:132-137)."""
    x0 = np.array([0.0, 0.0, 0.1])
    v, w, T = 0.2, 0.3, 1.2
    errs = []
    for n in [6, 12, 24]:
        dt = T / n
        F = integrators.make_step(unicycle.f, "euler", dt)
        X = integrators.rollout(F, jnp.asarray(x0), jnp.tile(jnp.array([v, w]), (n, 1)))
        errs.append(np.linalg.norm(np.asarray(X[-1]) - analytic_arc(x0, v, w, T)))
    assert errs[0] > errs[1] > errs[2]
    assert errs[0] / errs[2] > 2.5  # ~4x for first order


def test_rollout_shapes_and_first_row():
    F = integrators.make_step(unicycle.f, "euler", 0.2)
    x0 = jnp.array([1.0, 2.0, 3.0])
    U = jnp.zeros((5, 2))
    X = integrators.rollout(F, x0, U)
    assert X.shape == (6, 3)
    np.testing.assert_allclose(np.asarray(X[0]), np.asarray(x0))
    # zero controls hold the state
    np.testing.assert_allclose(np.asarray(X[-1]), np.asarray(x0))


def test_rollout_vmap():
    F = integrators.make_step(unicycle.f, "rk4", 0.2)
    x0s = jnp.zeros((16, 3))
    Us = jnp.ones((16, 10, 2)) * 0.1
    Xs = jax.vmap(lambda x0, U: integrators.rollout(F, x0, U))(x0s, Us)
    assert Xs.shape == (16, 11, 3)
    single = integrators.rollout(F, x0s[0], Us[0])
    np.testing.assert_allclose(np.asarray(Xs[5]), np.asarray(single), rtol=1e-6)
