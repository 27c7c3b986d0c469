"""The three reference MPC formulations as configurations of one solver.

The reference implements three near-duplicate CasADi ``Mpc`` classes:

* live point-stabilization (ros2_mpc/planner/local_planner_point_stabilization.py)
* live trajectory tracking (ros2_mpc/planner/local_planner_tracking.py)
* legacy point-stabilization (ros2_mpc/mpc_point_stabilization.py, dead code —
  imported nowhere, kept for capability parity)

Here each is an :class:`~ros2_mpc_jax.solver.ilqr.OCP` template plus a theta
builder; the solver core is shared. Weights and obstacle vectors live in the
runtime parameter pytree so Monte-Carlo tuning sweeps can ``vmap`` over them.

Reference behavioral quirks (SURVEY.md quirk ledger) are reproduced exactly
under ``reference_parity=True`` (the default) and corrected otherwise:

1. The live planners build an obstacle soft cost but never add it to the
   objective (local_planner_tracking.py:39-41 passes ``obstacles_cost=0``;
   local_planner_point_stabilization.py:104-127 ignores the argument). Parity
   keeps the cost inert; corrected mode activates it.
2. ``cost_factor``/``reverse_factor`` kwargs are swapped at the live
   point-stabilization and legacy call sites
   (local_planner_point_stabilization.py:43-47, mpc_point_stabilization.py:33-35):
   the reverse-penalty exponent is ``cost_factor`` and the obstacle gain is
   ``reverse_factor``. Parity preserves the swap.
3. Tracking integrates with Euler, point-stabilization with RK4
   (local_planner_tracking.py:34, local_planner_point_stabilization.py:38).
4. The tracking stage cost compares ``x_k`` against reference entry ``k+1`` of
   the parameter vector ``P_X = [x0, pf]`` (local_planner_tracking.py:120-123),
   i.e. ``pf[k]``; with ``x_0`` pinned to the initial state the k=0 term is
   constant.
5. No terminal state cost anywhere: stage sums run k = 0..N-1 over states
   (the legacy obstacle sum alone covers k = 0..N,
   mpc_point_stabilization.py:48).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..models import unicycle
from ..ops import costs
from ..ops.integrators import make_step
from .ilqr import OCP, SolverSettings, make_solver


class Problem(NamedTuple):
    """A ready-to-jit problem: ``solve(theta, U0) -> Solution`` plus helpers."""

    solve: callable
    make_theta: callable
    default_u0: jnp.ndarray  # (N, m) zeros — the reference's warm start
    ocp: OCP
    settings: SolverSettings
    kind: str = "point_stabilization"  # | "tracking" | "legacy"
    # build-time capability tags, e.g. "terminal_cost" when the optional
    # terminal pose weight is nonzero
    tags: tuple = ()


def _no_obstacles(params: Params, far: float = 1e3):
    """Padded obstacle vectors representing 'nothing nearby'. The reference
    uses 100 m sentinels on an empty scan
    (scripts/path_follower_local_planner.py:126-129)."""
    n = params.n_obstacle_points
    return jnp.full((n,), far), jnp.full((n,), far)


def make_point_stabilization(
    params: Params = Params(),
    *,
    reference_parity: bool = True,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
) -> Problem:
    """Live point-stabilization NMPC
    (ros2_mpc/planner/local_planner_point_stabilization.py:11-178).

    theta keys: ``x0`` (3,), ``goal`` (3,), ``obs_x``/``obs_y`` (n_obs,),
    ``Q`` (3,), ``R`` (2,), ``reverse_factor``, ``obstacle_gain``,
    ``inflation_radius``, ``obstacle_weight`` (0.0 under parity — quirk #1).
    """
    N = horizon if horizon is not None else params.N
    F = make_step(unicycle.f, "rk4", params.dt)  # quirk #3: RK4 here

    def stage_cost(x, u, k, theta):
        e = x - theta["goal"]
        c = (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
        )
        # Gaussian obstacle bumps (local_planner_point_stabilization.py:60-67);
        # weight 0.0 reproduces the reference's discarded cost (quirk #1).
        c = c + theta["obstacle_weight"] * costs.gaussian_obstacle_cost(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )
        return c

    def terminal_cost(x, theta):
        return 0.0

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.pointstab_v_bounds[0], params.pointstab_w_bounds[0]),
        u_hi=(params.pointstab_v_bounds[1], params.pointstab_w_bounds[1]),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params)
        return {
            "x0": jnp.asarray(x0, dtype=float),
            "goal": jnp.asarray(goal, dtype=float),
            "obs_x": jnp.asarray(obs_x, dtype=float),
            "obs_y": jnp.asarray(obs_y, dtype=float),
            "Q": jnp.asarray(params.Q, dtype=float),
            # R = 0.5 * I hardcoded (local_planner_point_stabilization.py:111-112)
            "R": jnp.full((2,), 0.5),
            # quirk #2: exponent is cost_factor, gain is reverse_factor
            "reverse_factor": jnp.asarray(params.cost_factor, dtype=float),
            "obstacle_gain": jnp.asarray(params.reverse_factor, dtype=float),
            "inflation_radius": jnp.asarray(params.inflation_radius, dtype=float),
            "obstacle_weight": jnp.asarray(0.0 if reference_parity else 1.0),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=jnp.zeros((N, 2)),
        ocp=ocp,
        settings=settings,
        kind="point_stabilization",
    )


def make_tracking(
    params: Params = Params(),
    *,
    reference_parity: bool = True,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
    terminal_weight=(0.0, 0.0, 0.0),
) -> Problem:
    """Live trajectory-tracking NMPC
    (ros2_mpc/planner/local_planner_tracking.py:11-178).

    theta keys: ``x0`` (3,), ``x_ref`` (N, 3), ``u_ref`` (N, 2), obstacle
    vectors, ``Q``, ``R``, ``reverse_factor``, ``obstacle_gain``,
    ``inflation_radius``, ``obstacle_weight``, ``terminal_weight``.

    ``terminal_weight`` is a per-axis (x, y, yaw) weight on an optional
    terminal pose cost ``||x_N - x_ref[N-1]||^2_W``. The reference has no
    terminal state cost anywhere (quirk #5), and with zero terminal weight
    the receding horizon prefers *orbiting* a misaligned goal over parking
    (the stage yaw weight Q[2]=0.005 never pays for the turn; see ROADMAP).
    The default zeros preserve parity; the closed-loop parking test pins the
    corrected behavior. All engines (vmap, fast, pallas) support the
    terminal quadratic; the Pallas tracking kernel carries the per-scenario
    weights in its packed weight plane.
    """
    N = horizon if horizon is not None else params.N
    F = make_step(unicycle.f, "euler", params.dt)  # quirk #3: Euler here

    # Under parity the (inert) cost keeps the reference's inverse-square
    # barrier form (local_planner_tracking.py:55-63). Corrected mode swaps in
    # the short-range Gaussian family from the point-stabilization planner
    # (local_planner_point_stabilization.py:60-67): the barrier's fat 1/r^2
    # tails summed over a dense wall out-pull the tracking gradient even at
    # ~1 m and drag the robot off its path — a latent bug the reference never
    # hits because its obstacle cost is dead code (quirk #1).
    obstacle_fn = costs.barrier_obstacle_cost if reference_parity else costs.gaussian_obstacle_cost

    def obstacle_term(x, theta):
        return theta["obstacle_weight"] * obstacle_fn(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )

    # Corrected mode wraps the yaw tracking error to (-pi, pi]: the
    # reference subtracts raw angles (CasADi X - P,
    # local_planner_tracking.py:118-122), so a robot whose continuous yaw
    # sits >pi from a wrapped-atan2 reference is charged for the LONG way
    # around and spends ~2pi/omega_max seconds spinning — the measured
    # mid-path stall family of the tracking fleet (round-5 diagnosis:
    # heading error -4.35 rad forced a 109-tick turn at the 0.2 rad/s
    # bound). The wrap is pure elementwise (round), gradient 1 a.e., and
    # every engine implements it — the Pallas kernel mirrors it in its
    # analytic derivatives via the OCP meta flag.
    wrap_yaw = not reference_parity

    def _yaw_err(e):
        if not wrap_yaw:
            return e
        two_pi = 2.0 * jnp.pi
        return e - two_pi * jnp.round(e / two_pi)

    def stage_cost(x, u, k, theta):
        # quirk #4: x_k is tracked against pf[k] (= P_X entry k+1).
        e_x = x - theta["x_ref"][k]
        e_x = e_x.at[2].set(_yaw_err(e_x[2]))
        e_u = u - theta["u_ref"][k]
        return (
            costs.quadratic_error(e_x, theta["Q"])
            + costs.quadratic_error(e_u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
            + obstacle_term(x, theta)
        )

    def terminal_cost(x, theta):
        # The reference's (inactive) obstacle sum covers k = 0..N
        # (local_planner_tracking.py:57); in corrected mode include stage N.
        e_N = x - theta["x_ref"][-1]
        e_N = e_N.at[2].set(_yaw_err(e_N[2]))
        return obstacle_term(x, theta) + costs.quadratic_error(e_N, theta["terminal_weight"])

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.tracking_v_bounds[0], params.tracking_w_bounds[0]),
        u_hi=(params.tracking_v_bounds[1], params.tracking_w_bounds[1]),
        meta=("wrap_yaw",) if wrap_yaw else (),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, x_ref, u_ref, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params)
        return {
            "x0": jnp.asarray(x0, dtype=float),
            "x_ref": jnp.asarray(x_ref, dtype=float).reshape(N, 3),
            "u_ref": jnp.asarray(u_ref, dtype=float).reshape(N, 2),
            "obs_x": jnp.asarray(obs_x, dtype=float),
            "obs_y": jnp.asarray(obs_y, dtype=float),
            "Q": jnp.asarray(params.Q, dtype=float),
            "R": jnp.asarray(params.R, dtype=float),
            "reverse_factor": jnp.asarray(params.reverse_factor, dtype=float),
            # parity: barrier gain = cost_factor (local_planner_tracking.py:61);
            # corrected: Gaussian gain = reverse_factor as in the
            # point-stabilization planner's call site (quirk #2).
            "obstacle_gain": jnp.asarray(
                params.cost_factor if reference_parity else params.reverse_factor, dtype=float
            ),
            "inflation_radius": jnp.asarray(params.inflation_radius, dtype=float),
            "obstacle_weight": jnp.asarray(0.0 if reference_parity else 1.0),
            "terminal_weight": jnp.asarray(terminal_weight, dtype=float).reshape(3),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=jnp.zeros((N, 2)),
        ocp=ocp,
        settings=settings,
        kind="tracking",
        tags=("terminal_cost",) if np.any(np.asarray(terminal_weight)) else (),
    )


def make_legacy_point_stabilization(
    params: Params = Params(),
    *,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
) -> Problem:
    """Legacy standalone point-stabilization NMPC
    (ros2_mpc/mpc_point_stabilization.py:9-149) — the only reference variant
    whose obstacle cost is live (:100), with hardcoded
    Q = diag(5e-5, 0.05, 0.05), R = 0.01*I (:85-93) and bounds
    v in [-0.2, 0.2], w in [-0.1, 0.1] (:80-83). Obstacle sum covers states
    k = 0..N (:48), so stage N lands in the terminal cost here.
    """
    N = horizon if horizon is not None else params.N
    F = make_step(unicycle.f, "rk4", params.dt)

    def obstacle_term(x, theta):
        return costs.barrier_obstacle_cost(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )

    def stage_cost(x, u, k, theta):
        e = x - theta["goal"]
        return (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
            + obstacle_term(x, theta)
        )

    def terminal_cost(x, theta):
        return obstacle_term(x, theta)

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.legacy_v_bounds[0], params.legacy_w_bounds[0]),
        u_hi=(params.legacy_v_bounds[1], params.legacy_w_bounds[1]),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params)
        return {
            "x0": jnp.asarray(x0, dtype=float),
            "goal": jnp.asarray(goal, dtype=float),
            "obs_x": jnp.asarray(obs_x, dtype=float),
            "obs_y": jnp.asarray(obs_y, dtype=float),
            "Q": jnp.asarray((0.00005, 0.05, 0.05)),
            "R": jnp.full((2,), 0.01),
            # quirk #2: exponent cost_factor, obstacle gain reverse_factor
            "reverse_factor": jnp.asarray(params.cost_factor, dtype=float),
            "obstacle_gain": jnp.asarray(params.reverse_factor, dtype=float),
            "inflation_radius": jnp.asarray(params.inflation_radius, dtype=float),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=jnp.zeros((N, 2)),
        ocp=ocp,
        settings=settings,
        kind="legacy",
    )
