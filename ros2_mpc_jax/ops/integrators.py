"""Fixed-step integrators and horizon rollouts.

The reference builds its shooting constraints by unrolling N symbolic Euler or
RK4 steps into the CasADi graph (``euler_integration`` / ``rk4`` at
ros2_mpc/planner/local_planner_tracking.py:132-151 and
ros2_mpc/planner/local_planner_point_stabilization.py:129-148). The tracking
planner uses Euler, point-stabilization uses RK4 — a behavioral difference we
preserve per problem spec.

Accelerator-native design: a single step function ``step(f, x, u, dt)`` plus a
``lax.scan`` rollout. Under ``jit`` the scan compiles to one fused on-device
loop; ``vmap`` adds the scenario batch axis so thousands of rollouts share one
program. No Python-level unrolling, no dynamic shapes.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Dynamics = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def euler_step(f: Dynamics, x: jnp.ndarray, u: jnp.ndarray, dt) -> jnp.ndarray:
    """One explicit-Euler step: matches local_planner_tracking.py:132-137."""
    return x + dt * f(x, u)


def rk4_step(f: Dynamics, x: jnp.ndarray, u: jnp.ndarray, dt) -> jnp.ndarray:
    """One classical RK4 step with zero-order-hold control: matches
    local_planner_point_stabilization.py:136-148."""
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


STEPPERS = {"euler": euler_step, "rk4": rk4_step}


def make_step(f: Dynamics, integrator: str, dt) -> Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
    """Discrete transition ``F(x, u) -> x_next`` for a named integrator."""
    stepper = STEPPERS[integrator]

    def F(x, u):
        return stepper(f, x, u, dt)

    return F


def rollout(F: Callable, x0: jnp.ndarray, U: jnp.ndarray) -> jnp.ndarray:
    """Roll controls ``U: (N, m)`` from ``x0: (n,)`` through transition ``F``.

    Returns the full state trajectory ``X: (N+1, n)`` with ``X[0] == x0`` —
    the same object the reference represents as its (n, N+1) decision-variable
    matrix bound by shooting equality constraints
    (local_planner_tracking.py:153-155). Here the constraint is eliminated by
    construction (single shooting), which is exact for the same integrator.
    """

    def body(x, u):
        x_next = F(x, u)
        return x_next, x_next

    _, X_tail = jax.lax.scan(body, x0, U)
    return jnp.concatenate([x0[None, :], X_tail], axis=0)
