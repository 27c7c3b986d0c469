"""Fleet closed-loop evaluation: thousands of simulated robots, one program.

BASELINE.json config 3 is "the full nav loop at fixed control rate"; the
reference runs exactly one robot per process. Here the *entire closed loop*
— per-tick NMPC solve bank, first-control actuation of a vmapped plant,
shift-and-hold warm starts — is a single jitted ``lax.scan`` over control
ticks. One compiled program rolls a whole Monte-Carlo fleet of
(start, goal) scenarios forward in time: the evaluation harness for
controller changes, weight sweeps, and regression gates at fleet scale
("many solves, many chips, one program", SURVEY.md §2).

Obstacles default to far sentinels (open-floor evaluation); pass per-robot
obstacle vectors for cluttered scenes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import unicycle
from ..ops.integrators import rk4_step
from ..solver.warmstart import shift_controls


class FleetResult(NamedTuple):
    final_states: jnp.ndarray  # (B, 3)
    goal_dist: jnp.ndarray  # (B,) final planar distance to goal
    reach_fraction: jnp.ndarray  # scalar: goal_dist < threshold
    mean_dist: jnp.ndarray  # scalar
    trajectories: Optional[jnp.ndarray]  # (T+1, B, 3) when record=True


def _make_batched_solve(problem, engine: str, allow_tracking=False, **engine_opts):
    """Scenario-bank solve for the fleet tick.

    The goal-driven fleet/swarm rollouts take point-stabilization banks; the
    tracking fleet (:func:`make_tracking_fleet_rollout`) passes
    ``allow_tracking=True`` and routes tracking problems to the tracking
    kernels (compiled or interpreted as
    :func:`~ros2_mpc_jax.solver.pallas_kernel.pallas_interpret` decides)."""
    kind = getattr(problem, "kind", "point_stabilization")
    allowed = ("point_stabilization", "legacy") + (("tracking",) if allow_tracking else ())
    if kind not in allowed:
        hint = (
            "use make_tracking_fleet_rollout for tracking problems (per-robot "
            "reference windows advancing along per-robot paths)"
            if kind == "tracking"
            else "model-generic problem families need the vmap engine nodes"
        )
        raise ValueError(
            f"this fleet rollout takes {allowed} problems; got {kind!r} — {hint}"
        )
    if engine == "fast":
        from ..solver.batched import make_bank_solver_fast

        return make_bank_solver_fast(problem.ocp, problem.settings, **engine_opts)
    if engine == "pallas":
        from ..solver.pallas_kernel import (
            make_pallas_point_stab_solver,
            make_pallas_tracking_solver,
        )

        maker = make_pallas_tracking_solver if kind == "tracking" else make_pallas_point_stab_solver
        return maker(problem.ocp, problem.settings, **engine_opts)
    if engine_opts:
        raise ValueError(
            f"engine='vmap' takes no engine_opts, got {sorted(engine_opts)}"
        )
    return jax.vmap(problem.solve)


def _make_rollout_body(problem, n_ticks, dt, record, engine, **engine_opts):
    """The per-shard closed loop: ``body(thetas, U0s) -> (xs, traj|None)``
    with every output B-leading (so it shards cleanly over the scenario
    axis — no cross-robot coupling anywhere inside the scan)."""
    batched_solve = _make_batched_solve(problem, engine, **engine_opts)

    def plant(x, u):
        return rk4_step(unicycle.f, x, u, dt)

    def body(thetas, U0s):
        x0s = thetas["x0"]

        def tick(carry, _):
            xs, warm = carry
            th = dict(thetas)
            th["x0"] = xs
            sols = batched_solve(th, warm)
            u0 = sols.U[:, 0]
            u0 = jnp.where(jnp.isfinite(u0), u0, 0.0)  # graceful degradation
            xs_next = jax.vmap(plant)(xs, u0)
            warm_next = jax.vmap(shift_controls)(sols.U)
            return (xs_next, warm_next), (xs_next if record else None)

        (xs, _), traj = jax.lax.scan(tick, (x0s, U0s), None, length=n_ticks)
        if record:
            return xs, jnp.concatenate([x0s[None], traj], axis=0)
        return xs, None

    return body


def _fleet_summary(xs, traj, thetas, goal_threshold):
    goal_dist = jnp.linalg.norm(xs[:, :2] - thetas["goal"][:, :2], axis=-1)
    return FleetResult(
        final_states=xs,
        goal_dist=goal_dist,
        reach_fraction=jnp.mean((goal_dist < goal_threshold).astype(jnp.float32)),
        mean_dist=jnp.mean(goal_dist),
        trajectories=traj,
    )


def make_fleet_rollout(
    problem,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """Build ``rollout(thetas, U0s) -> FleetResult`` — the full closed loop
    under jit. ``thetas`` is a B-leading point-stabilization bank (the goal
    field drives each robot); plant integration is RK4 at the control rate.
    ``engine``: 'vmap' | 'fast' (lane-aligned) | 'pallas' (whole-solver
    kernel; bank a multiple of its tile).
    """
    body = _make_rollout_body(problem, n_ticks, dt, record, engine, **engine_opts)

    def rollout(thetas, U0s):
        xs, traj = body(thetas, U0s)
        return _fleet_summary(xs, traj, thetas, goal_threshold)

    return jax.jit(rollout)


def make_sharded_fleet_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """The fleet closed loop sharded over a device mesh: each device runs the
    whole ``lax.scan`` control loop on its local scenario shard (robots are
    independent, so no per-tick collectives exist to pay for), and only the
    end-of-rollout fleet statistics (reach fraction, mean goal distance)
    reduce across the mesh. This is BASELINE config 3 at mesh scale: K devices
    roll K x (B/K) robots in the same wall-clock as one chip rolls B/K.

    Per-device batch must satisfy the engine packing ('fast': multiple of
    ``lanes``; 'pallas': multiple of ``tile_s * tile_l``). Inputs should be
    placed with :func:`~ros2_mpc_jax.parallel.mesh.shard_bank`.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis_names = tuple(mesh.axis_names)
    batch_spec = P(axis_names)
    shard = NamedSharding(mesh, batch_spec)

    body = _make_rollout_body(
        problem,
        n_ticks,
        dt,
        record,
        engine,
        **engine_opts,
    )

    def per_shard(thetas, U0s):
        xs, traj = body(thetas, U0s)
        return (xs, traj) if record else xs

    sharded_body = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(batch_spec, batch_spec),
        out_specs=(batch_spec, P(None, *axis_names)) if record else batch_spec,
        check_vma=False,
    )

    def rollout(thetas, U0s):
        out = sharded_body(thetas, U0s)
        xs, traj = out if record else (out, None)
        # reductions happen outside the shard_map: GSPMD lowers the means to
        # all-reduces over the mesh
        return _fleet_summary(xs, traj, thetas, goal_threshold)

    return jax.jit(rollout, in_shardings=(shard, shard))


class TrackingFleetResult(NamedTuple):
    final_states: jnp.ndarray  # (B, 3)
    goal_dist: jnp.ndarray  # (B,) final distance to the path's last waypoint
    reach_fraction: jnp.ndarray  # scalar: goal_dist < threshold
    mean_cross_track: jnp.ndarray  # scalar: mean over robots+ticks of the
    #   distance to the nearest waypoint (the tracking-quality number)
    max_cross_track: jnp.ndarray  # scalar: worst excursion anywhere
    trajectories: Optional[jnp.ndarray]  # (T+1, B, 3) when record=True
    converged: Optional[jnp.ndarray] = None  # (T, B) per-tick solve convergence when record=True


def _tracking_window(pos, goal, wps, yaw, speed, omega, horizon):
    """Per-robot reference window, in-jit — the fleet-scale twin of
    nodes/reference_gen.py::tracking_reference_window (reference semantics:
    scripts/path_follower_local_planner.py:26-73):

    * anchor at the waypoint nearest the robot;
    * within 0.5 m of the final waypoint the state reference collapses to
      ``horizon`` copies of the goal pose (terminal latch);
    * windows running past the end hold the final sample.

    One corrected-mode deviation: inside the terminal latch the *velocity*
    reference is zeroed as well, so the MPC brakes and parks. The reference
    keeps commanding the window's profile speed there
    (path_follower_local_planner.py:61-66) and relies on its hardcoded
    0.15 m node latch to catch the fly-by — a robot that misses it drives
    straight through the goal (the ROADMAP goal-orbiting family).

    Returns ``(x_ref (N,3), u_ref (N,2), cross_track)``."""
    d2 = jnp.sum((wps - pos[None, :]) ** 2, axis=1)
    anchor = jnp.argmin(d2)
    rows = jnp.minimum(anchor + jnp.arange(horizon), wps.shape[0] - 1)
    near_end = jnp.sum((pos - wps[-1]) ** 2) < 0.25  # 0.5 m terminal latch
    xr_path = jnp.concatenate([wps[rows], yaw[rows][:, None]], axis=1)
    x_ref = jnp.where(near_end, jnp.broadcast_to(goal, (horizon, 3)), xr_path)
    u_ref = jnp.where(near_end, 0.0, jnp.stack([speed[rows], omega[rows]], axis=1))
    return x_ref, u_ref, jnp.sqrt(d2[anchor])


DEFAULT_HANDOFF_RADIUS = 0.35
DEFAULT_HANDOFF_Q = (5.0, 5.0, 0.05)
DEFAULT_HANDOFF_TERMINAL = (50.0, 50.0, 5.0)


def _make_tracking_rollout_body(
    problem,
    n_ticks,
    dt,
    record,
    engine,
    latch_radius=0.15,
    handoff_radius=DEFAULT_HANDOFF_RADIUS,
    handoff_q=DEFAULT_HANDOFF_Q,
    handoff_terminal=DEFAULT_HANDOFF_TERMINAL,
    **engine_opts,
):
    """Per-shard tracking closed loop: every tick regenerates each robot's
    reference window from its own path (nearest-point anchor advancing as the
    robot moves), solves the tracking bank, actuates the first control, and
    shifts the warm start. Within ``latch_radius`` of the path end the robot
    latches to zero velocity — the reference node's hardcoded 0.15 m goal
    latch (path_follower_local_planner.py:205-219, quirk #9); without it the
    u_ref pull drives robots straight through their goals.

    **Parking handoff** (round-4 verdict item 3): inside ``handoff_radius``
    of the goal a robot's solve switches to point-stabilization gains —
    per-robot ``Q``/``terminal_weight`` overridden to
    ``handoff_q``/``handoff_terminal`` via ``jnp.where``, the in-scan twin
    of the node-level handoff (nodes/path_follower.py). The tracking
    weights (reference Q = (1, 1, 0.005)) reward staying ON the path more
    than arriving; a robot that misses the 0.15 m latch orbits the goal at
    its turn-rate bound (measured 5.4% of the bench fleet). The parking
    gains make arrival pay. Works with every engine — the Pallas tracking
    kernel carries Q and the terminal weights per scenario in its packed
    weight plane. Pass ``handoff_radius=None`` to disable (pre-round-5
    behavior). All outputs B-leading."""
    if getattr(problem, "kind", None) != "tracking":
        raise ValueError(
            "make_tracking_fleet_rollout takes a tracking problem "
            "(solver.problems.make_tracking); goal-driven banks go to "
            "make_fleet_rollout"
        )
    batched_solve = _make_batched_solve(
        problem,
        engine,
        allow_tracking=True,
        **engine_opts,
    )
    N = problem.ocp.horizon
    hq = None if handoff_radius is None else jnp.asarray(handoff_q, dtype=jnp.float32)
    htw = (
        None
        if handoff_radius is None
        else jnp.asarray(handoff_terminal, dtype=jnp.float32)
    )
    # With the corrected-mode yaw-error wrap in the OCP (make_tracking
    # meta="wrap_yaw") the cost is 2pi-periodic in the state yaw, so the
    # plant yaw can be wrapped at every tick boundary — keeping it inside
    # the Pallas polynomial sin/cos validity range (|x| <= 60) for rollouts of any
    # length (advisor round-4 finding). Parity-formulation fleets keep the
    # raw integrated yaw (wrapping would change their cost); their bound is
    # |yaw| <= 60 rad, i.e. >= 1500 ticks at the reference's 0.2 rad/s.
    wrap_state = "wrap_yaw" in getattr(problem.ocp, "meta", ())

    def plant(x, u):
        xn = rk4_step(unicycle.f, x, u, dt)
        if wrap_state:
            two_pi = 2.0 * jnp.pi
            xn = xn.at[2].set(xn[2] - two_pi * jnp.round(xn[2] / two_pi))
        return xn

    def body(thetas, paths, U0s):
        x0s = thetas["x0"]
        goals = jnp.concatenate(
            [paths["wps"][:, -1], paths["yaw"][:, -1:]], axis=1
        )  # (B, 3): path end pose

        def tick(carry, _):
            xs, warm, latched, ct_sum, ct_max = carry
            x_ref, u_ref, ct = jax.vmap(
                lambda x, g, w, y, s, o: _tracking_window(x[:2], g, w, y, s, o, N)
            )(xs, goals, paths["wps"], paths["yaw"], paths["speed"], paths["omega"])
            th = dict(thetas)
            th["x0"] = xs
            th["x_ref"] = x_ref
            th["u_ref"] = u_ref
            if handoff_radius is not None:
                # branch-free per-robot point-stab handoff near the goal
                near = (
                    jnp.sum((xs[:, :2] - goals[:, :2]) ** 2, axis=1)
                    < handoff_radius**2
                )
                th["Q"] = jnp.where(near[:, None], hq[None], thetas["Q"])
                th["terminal_weight"] = jnp.where(
                    near[:, None], htw[None], thetas["terminal_weight"]
                )
            sols = batched_solve(th, warm)
            u0 = sols.U[:, 0]
            u0 = jnp.where(jnp.isfinite(u0), u0, 0.0)
            # sticky goal latch (quirk #9): stop inside latch_radius for good
            latched = jnp.logical_or(
                latched,
                jnp.sum((xs[:, :2] - goals[:, :2]) ** 2, axis=1) < latch_radius**2,
            )
            u0 = jnp.where(latched[:, None], 0.0, u0)
            xs_next = jax.vmap(plant)(xs, u0)
            warm_next = jax.vmap(shift_controls)(sols.U)
            return (
                (xs_next, warm_next, latched, ct_sum + ct, jnp.maximum(ct_max, ct)),
                (xs_next, sols.converged) if record else None,
            )

        zeros = jnp.zeros(x0s.shape[0])
        (xs, _, _, ct_sum, ct_max), rec = jax.lax.scan(
            tick,
            (x0s, U0s, jnp.zeros(x0s.shape[0], dtype=bool), zeros, zeros),
            None,
            length=n_ticks,
        )
        if record:
            rec = (jnp.concatenate([x0s[None], rec[0]], axis=0), rec[1])
        return xs, ct_sum / n_ticks, ct_max, goals, rec

    return body


def _tracking_summary(xs, ct_mean, ct_max, goals, rec, goal_threshold):
    goal_dist = jnp.linalg.norm(xs[:, :2] - goals[:, :2], axis=-1)
    traj, conv = rec if rec is not None else (None, None)
    return TrackingFleetResult(
        final_states=xs,
        goal_dist=goal_dist,
        reach_fraction=jnp.mean((goal_dist < goal_threshold).astype(jnp.float32)),
        mean_cross_track=jnp.mean(ct_mean),
        max_cross_track=jnp.max(ct_max),
        trajectories=traj,
        converged=conv,
    )


def make_tracking_fleet_rollout(
    problem,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """Closed-loop *tracking* fleet under one jit: the fleet-scale evaluator
    for the reference's flagship loop (path following,
    scripts/path_follower_local_planner.py:134-223). Each robot carries its
    own path; every control tick the reference window is regenerated on
    device (nearest-waypoint anchor, 0.5 m terminal latch, clamped windows),
    the tracking bank solves, and the first control drives an RK4 plant
    (the solver's Euler shooting vs the RK4 truth is the same model mismatch
    the live node sees).

    ``rollout(thetas, paths, U0s) -> TrackingFleetResult`` where ``paths`` is
    a dict of B-leading arrays ``wps (B,P,2)``, ``yaw (B,P)``, ``speed
    (B,P)``, ``omega (B,P)`` (see :func:`arc_path_fleet`). ``engine``:
    'vmap' | 'fast' | 'pallas' (the tracking kernel). ``latch_radius=``
    (default 0.15, the reference's hardcoded goal latch) is accepted among
    the engine opts."""
    body = _make_tracking_rollout_body(problem, n_ticks, dt, record, engine, **engine_opts)

    def rollout(thetas, paths, U0s):
        xs, ct_mean, ct_max, goals, rec = body(thetas, paths, U0s)
        return _tracking_summary(xs, ct_mean, ct_max, goals, rec, goal_threshold)

    return jax.jit(rollout)


def make_sharded_tracking_fleet_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """The tracking fleet sharded over a device mesh — robots are independent
    (each follows its own path), so each device runs the whole closed loop on
    its local shard and only the fleet statistics reduce across the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis_names = tuple(mesh.axis_names)
    batch_spec = P(axis_names)
    shard = NamedSharding(mesh, batch_spec)

    body = _make_tracking_rollout_body(
        problem,
        n_ticks,
        dt,
        record,
        engine,
        **engine_opts,
    )

    def per_shard(thetas, paths, U0s):
        xs, ct_mean, ct_max, goals, rec = body(thetas, paths, U0s)
        if record:
            return xs, ct_mean, ct_max, goals, rec
        return xs, ct_mean, ct_max, goals

    tick_spec = P(None, *axis_names)
    out_specs = (
        (batch_spec, batch_spec, batch_spec, batch_spec, (tick_spec, tick_spec))
        if record
        else (batch_spec, batch_spec, batch_spec, batch_spec)
    )
    sharded_body = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(batch_spec, batch_spec, batch_spec),
        out_specs=out_specs,
        check_vma=False,
    )

    def rollout(thetas, paths, U0s):
        out = sharded_body(thetas, paths, U0s)
        xs, ct_mean, ct_max, goals = out[0], out[1], out[2], out[3]
        rec = out[4] if record else None
        return _tracking_summary(xs, ct_mean, ct_max, goals, rec, goal_threshold)

    return jax.jit(rollout, in_shardings=(shard, shard, shard))


def arc_path_fleet(
    problem,
    B: int,
    n_waypoints: int = 64,
    seed: int = 0,
    start_jitter: float = 0.05,
):
    """A (theta bank, path bank, warm start) for the tracking fleet: B
    constant-curvature arc paths with the reference's motion-profile
    contract (nodes/reference_gen.py::path_motion_profile — speed is segment
    length / dt *doubled*, turn-rate is the yaw difference *halved*,
    path_follower_local_planner.py:14-23). Waypoint spacing is chosen so the
    doubled profile speed lands inside the tracking velocity bounds. Robots
    start near (not on) their path with heading error, so the rollout
    exercises acquisition as well as following."""
    rng = np.random.default_rng(seed)
    dt_probe = problem.ocp.transition(np.zeros(3), np.array([0.0, 1.0]))[2]
    dt = float(dt_probe)
    v_hi = float(problem.ocp.u_hi[0])
    P = n_waypoints
    # nominal path speed: the doubled parity profile must stay within bounds
    v_nom = rng.uniform(0.3 * v_hi, 0.5 * v_hi, size=(B, 1))
    ds = v_nom * dt  # -> profile speed = 2 * v_nom in [0.6, 1.0] * v_hi
    kappa = rng.uniform(-0.6, 0.6, size=(B, 1))  # 1/m curvature
    yaw0 = rng.uniform(-np.pi, np.pi, size=(B, 1))
    s = np.arange(P)[None, :] * ds  # (B, P) arclength
    heading = yaw0 + kappa * s
    # unicycle arc: integrate heading along arclength (exact for constant ds)
    wx = np.cumsum(np.cos(heading) * ds, axis=1) - np.cos(heading[:, :1]) * ds
    wy = np.cumsum(np.sin(heading) * ds, axis=1) - np.sin(heading[:, :1]) * ds
    start = rng.uniform(-1.0, 1.0, size=(B, 2))
    wps = np.stack([wx + start[:, :1], wy + start[:, 1:]], axis=2)  # (B, P, 2)

    # parity motion profile (vectorized path_motion_profile)
    steps = np.diff(wps, axis=1)
    yaw = np.arctan2(steps[..., 1], steps[..., 0])
    yaw = np.concatenate([yaw, yaw[:, -1:]], axis=1)  # (B, P)
    omega = np.diff(yaw, axis=1) / 2.0
    omega = np.concatenate([omega, omega[:, -1:]], axis=1)  # clamped tail
    speed = np.hypot(steps[..., 0], steps[..., 1]) / dt * 2.0
    speed = np.concatenate([speed, speed[:, -1:]], axis=1)

    x0 = np.concatenate(
        [
            wps[:, 0] + rng.uniform(-start_jitter, start_jitter, size=(B, 2)),
            yaw[:, :1] + rng.uniform(-0.4, 0.4, size=(B, 1)),
        ],
        axis=1,
    )
    N = problem.ocp.horizon
    thetas = jax.vmap(problem.make_theta)(
        jnp.asarray(x0), jnp.zeros((B, N, 3)), jnp.zeros((B, N, 2))
    )
    paths = {
        "wps": jnp.asarray(wps, dtype=jnp.float32),
        "yaw": jnp.asarray(yaw, dtype=jnp.float32),
        "speed": jnp.asarray(speed, dtype=jnp.float32),
        "omega": jnp.asarray(omega, dtype=jnp.float32),
    }
    U0 = jnp.zeros((B, N, 2))
    return thetas, paths, U0


def make_generic_fleet_rollout(
    problem,
    n_ticks: int,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "fast",
    pos_dims: Optional[int] = None,
    **engine_opts,
):
    """Closed-loop fleet evaluator for ANY model family: solve -> actuate ->
    shift under one jit, with the OCP's own ``transition`` as the plant
    (exact-model closed loop — the unicycle fleets above deliberately keep
    the reference's RK4-plant/Euler-solver mismatch; this one evaluates the
    family itself). The round-5 generic engine makes this one function for
    every family: the 12-state quadrotor fleet runs at bank throughput
    through the same code as a bicycle fleet.

    ``thetas`` must carry ``x0`` and a ``goal`` whose leading components
    are a position (2 planar / 3 spatial — inferred from the goal width,
    override with ``pos_dims``). ``engine``: 'fast' (generic lane-aligned)
    | 'vmap'. Returns :class:`FleetResult` (goal_dist over the position
    components)."""
    kind = getattr(problem, "kind", "")
    if kind == "tracking":
        raise ValueError("tracking problems go to make_tracking_fleet_rollout")
    if engine == "fast":
        from ..solver.batched import make_bank_solver_fast

        batched_solve = make_bank_solver_fast(
            problem.ocp, problem.settings, **engine_opts
        )
    elif engine == "vmap":
        if engine_opts:
            raise ValueError(f"engine='vmap' takes no engine_opts, got {sorted(engine_opts)}")
        batched_solve = jax.vmap(problem.solve)
    else:
        raise ValueError(f"generic fleet takes engine='fast'|'vmap', got {engine!r}")
    F = problem.ocp.transition

    def rollout(thetas, U0s):
        x0s = thetas["x0"]
        pd = pos_dims or (3 if thetas["goal"].shape[-1] >= 4 else 2)

        def tick(carry, _):
            xs, warm = carry
            th = dict(thetas)
            th["x0"] = xs
            sols = batched_solve(th, warm)
            u0 = sols.U[:, 0]
            u0 = jnp.where(jnp.isfinite(u0), u0, 0.0)
            xs_next = jax.vmap(F)(xs, u0)
            warm_next = jax.vmap(shift_controls)(sols.U)
            return (xs_next, warm_next), (xs_next if record else None)

        (xs, _), traj = jax.lax.scan(tick, (x0s, U0s), None, length=n_ticks)
        goal_dist = jnp.linalg.norm(
            xs[:, :pd] - thetas["goal"][:, :pd], axis=-1
        )
        return FleetResult(
            final_states=xs,
            goal_dist=goal_dist,
            reach_fraction=jnp.mean((goal_dist < goal_threshold).astype(jnp.float32)),
            mean_dist=jnp.mean(goal_dist),
            trajectories=jnp.concatenate([x0s[None], traj], axis=0) if record else None,
        )

    return jax.jit(rollout)


class SwarmResult(NamedTuple):
    final_states: jnp.ndarray  # (B, 3)
    goal_dist: jnp.ndarray  # (B,)
    reach_fraction: jnp.ndarray  # scalar
    mean_dist: jnp.ndarray  # scalar
    min_separation: jnp.ndarray  # scalar: closest any two robots ever got
    trajectories: Optional[jnp.ndarray]  # (T+1, B, 3) when record=True


DEFAULT_PREDICT_TAUS = (0.0, 0.8)
DEFAULT_AVOIDANCE_RADIUS = 0.3
DEFAULT_AVOIDANCE_WEIGHT = 1.0


def _swarm_obstacle_theta(thetas, xs, nbr_pos, nbr_vel, taus, radius, weight):
    """Per-tick theta: each of the k nearest neighbors enters the live
    obstacle prefix as a short constant-velocity *sweep* — its position
    extrapolated to the ``taus`` offsets. Static-point avoidance alone
    fails head-on (both robots dodge the other's stale position and meet
    anyway — the classic velocity-obstacle failure); the sweep makes the
    oncoming robot's near future visible to the solver. Caller-provided
    static obstacles survive in the remaining slots."""
    pred = nbr_pos[:, :, None, :] + nbr_vel[:, :, None, :] * taus[None, None, :, None]
    obs = pred.reshape(pred.shape[0], -1, 2)  # (B, k * n_taus, 2)
    n_used = obs.shape[1]
    th = dict(thetas)
    th["x0"] = xs
    th["obs_x"] = jnp.concatenate([obs[..., 0], thetas["obs_x"][:, n_used:]], axis=1)
    th["obs_y"] = jnp.concatenate([obs[..., 1], thetas["obs_y"][:, n_used:]], axis=1)
    if radius is not None:
        th["inflation_radius"] = jnp.full(xs.shape[:1], radius)
    if weight is not None:
        th["obstacle_weight"] = jnp.full(xs.shape[:1], weight)
    return th


def make_swarm_rollout(
    problem,
    n_ticks: int,
    dt: float,
    k_neighbors: int = 4,
    predict_taus=DEFAULT_PREDICT_TAUS,
    avoidance_radius: Optional[float] = DEFAULT_AVOIDANCE_RADIUS,
    avoidance_weight: Optional[float] = DEFAULT_AVOIDANCE_WEIGHT,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """Closed-loop multi-robot swarm under one jit: every control tick, each
    robot's k nearest neighbors enter its live obstacle slots as
    constant-velocity sweeps, so the whole fleet mutually avoids through the
    soft obstacle cost alone — no robot-to-robot messaging, the shared-world
    behavior of nodes/multi_robot.py at chip scale (the B x B neighbor
    search is one batched distance matrix + top_k per tick).

    ``problem`` must be a corrected-mode point stabilization (the parity
    formulation's dead obstacle cost cannot avoid anything, quirk #1).
    ``avoidance_radius`` / ``avoidance_weight`` override the theta's
    inflation_radius / obstacle_weight each tick (pass None to keep the
    bank's own values). Defaults were tuned on the antipodal-circle swap:
    all robots reach their goals with >= 0.3 m minimum separation
    (tests/test_swarm.py). Perfectly symmetric fleets deadlock at the saddle
    — jitter the starts (see :func:`circle_swarm`).

    Heading is integrated unwrapped here (point-stabilization costs are not
    2pi-periodic in the state yaw, so wrapping would change them): with the
    Pallas engines' polynomial sin/cos (validity |x| <= 60 rad) that bounds
    safe rollouts to ~1500 ticks at the reference's 0.2 rad/s turn-rate cap —
    far above any configured swarm run; use the 'fast' or 'vmap' engine for
    longer soaks."""
    if k_neighbors < 1:
        raise ValueError("k_neighbors must be >= 1")
    if len(predict_taus) < 1:
        raise ValueError("predict_taus must name at least one horizon offset")
    batched_solve = _make_batched_solve(problem, engine, **engine_opts)
    taus = jnp.asarray(predict_taus, dtype=jnp.float32)

    def plant(x, u):
        return rk4_step(unicycle.f, x, u, dt)

    def rollout(thetas, U0s):
        x0s = thetas["x0"]
        B = x0s.shape[0]
        if k_neighbors >= B:
            raise ValueError(f"k_neighbors={k_neighbors} must be < fleet size {B}")
        if k_neighbors * len(predict_taus) > thetas["obs_x"].shape[1]:
            raise ValueError("k_neighbors * len(predict_taus) exceeds the obstacle slots")

        def tick(carry, _):
            xs, prev_pos, warm, sep = carry
            pos = xs[:, :2]
            vel = (pos - prev_pos) / dt
            diff = pos[:, None, :] - pos[None, :, :]
            d2 = jnp.sum(diff * diff, axis=-1) + jnp.eye(B) * 1e9
            _, idx = jax.lax.top_k(-d2, k_neighbors)
            th = _swarm_obstacle_theta(
                thetas, xs, pos[idx], vel[idx], taus, avoidance_radius, avoidance_weight
            )
            sols = batched_solve(th, warm)
            u0 = sols.U[:, 0]
            u0 = jnp.where(jnp.isfinite(u0), u0, 0.0)
            xs_next = jax.vmap(plant)(xs, u0)
            warm_next = jax.vmap(shift_controls)(sols.U)
            sep = jnp.minimum(sep, jnp.sqrt(jnp.min(d2, axis=1)))
            return (xs_next, pos, warm_next, sep), (xs_next if record else None)

        sep0 = jnp.full((B,), jnp.inf)
        (xs, _, _, sep), traj = jax.lax.scan(
            tick, (x0s, x0s[:, :2], U0s, sep0), None, length=n_ticks
        )
        goal_dist = jnp.linalg.norm(xs[:, :2] - thetas["goal"][:, :2], axis=-1)
        return SwarmResult(
            final_states=xs,
            goal_dist=goal_dist,
            reach_fraction=jnp.mean((goal_dist < goal_threshold).astype(jnp.float32)),
            mean_dist=jnp.mean(goal_dist),
            min_separation=jnp.min(sep),
            trajectories=jnp.concatenate([x0s[None], traj], axis=0) if record else None,
        )

    return jax.jit(rollout)


def make_sharded_swarm_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    k_neighbors: int = 4,
    predict_taus=DEFAULT_PREDICT_TAUS,
    avoidance_radius: Optional[float] = DEFAULT_AVOIDANCE_RADIUS,
    avoidance_weight: Optional[float] = DEFAULT_AVOIDANCE_WEIGHT,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine: str = "vmap",
    **engine_opts,
):
    """The swarm rollout sharded over a 1D device mesh. Unlike the plain
    fleet (embarrassingly parallel), the swarm genuinely couples robots:
    every tick each device ``all_gather``s the fleet's positions and
    velocities over the mesh axis — per-tick collectives, over NVLink on
    one host of GPUs — then searches its local robots' neighbors against the
    global tables. Everything else (solve bank, plant, warm-start shift)
    stays local."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if len(mesh.axis_names) != 1:
        raise ValueError("swarm sharding expects a 1D mesh (one robot axis)")
    if k_neighbors < 1:
        raise ValueError("k_neighbors must be >= 1")
    if len(predict_taus) < 1:
        raise ValueError("predict_taus must name at least one horizon offset")
    axis = mesh.axis_names[0]
    batch_spec = P(axis)
    shard = NamedSharding(mesh, batch_spec)
    batched_solve = _make_batched_solve(problem, engine, **engine_opts)
    taus = jnp.asarray(predict_taus, dtype=jnp.float32)

    def plant(x, u):
        return rk4_step(unicycle.f, x, u, dt)

    def per_shard(thetas, U0s):
        x0s = thetas["x0"]
        B_local = x0s.shape[0]
        offset = jax.lax.axis_index(axis) * B_local

        def tick(carry, _):
            xs, prev_pos, warm, sep = carry
            pos = xs[:, :2]
            vel = (pos - prev_pos) / dt
            all_pos = jax.lax.all_gather(pos, axis, tiled=True)  # (B_global, 2)
            all_vel = jax.lax.all_gather(vel, axis, tiled=True)
            diff = pos[:, None, :] - all_pos[None, :, :]
            d2 = jnp.sum(diff * diff, axis=-1)  # (B_local, B_global)
            row = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0) + offset
            col = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
            d2 = jnp.where(row == col, 1e9, d2)  # exclude self
            _, idx = jax.lax.top_k(-d2, k_neighbors)
            th = _swarm_obstacle_theta(
                thetas, xs, all_pos[idx], all_vel[idx], taus, avoidance_radius, avoidance_weight
            )
            sols = batched_solve(th, warm)
            u0 = sols.U[:, 0]
            u0 = jnp.where(jnp.isfinite(u0), u0, 0.0)
            xs_next = jax.vmap(plant)(xs, u0)
            warm_next = jax.vmap(shift_controls)(sols.U)
            sep = jnp.minimum(sep, jnp.sqrt(jnp.min(d2, axis=1)))
            return (xs_next, pos, warm_next, sep), (xs_next if record else None)

        sep0 = jnp.full((B_local,), jnp.inf)
        (xs, _, _, sep), traj = jax.lax.scan(
            tick, (x0s, x0s[:, :2], U0s, sep0), None, length=n_ticks
        )
        if record:
            return xs, sep, jnp.concatenate([x0s[None], traj], axis=0)
        return xs, sep

    sharded = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(batch_spec, batch_spec),
        out_specs=(batch_spec, batch_spec, P(None, axis)) if record else (batch_spec, batch_spec),
        check_vma=False,
    )

    def rollout(thetas, U0s):
        out = sharded(thetas, U0s)
        xs, sep = out[0], out[1]
        traj = out[2] if record else None
        goal_dist = jnp.linalg.norm(xs[:, :2] - thetas["goal"][:, :2], axis=-1)
        return SwarmResult(
            final_states=xs,
            goal_dist=goal_dist,
            reach_fraction=jnp.mean((goal_dist < goal_threshold).astype(jnp.float32)),
            mean_dist=jnp.mean(goal_dist),
            min_separation=jnp.min(sep),
            trajectories=traj,
        )

    return jax.jit(rollout, in_shardings=(shard, shard))


def circle_swarm(problem, B: int, radius: float = 2.0, jitter: float = 0.06, seed: int = 0):
    """The classic antipodal-swap scenario: B robots on a circle, each goal
    diametrically opposite — every straight-line plan collides at the
    center, so reaching goals with separation intact demonstrates live
    mutual avoidance. ``jitter`` perturbs the starts: a bit-perfect mirror
    fleet sits on the avoidance saddle (zero sideways gradient) and
    deadlocks, which no physical fleet ever is."""
    ang = 2 * np.pi * np.arange(B) / B
    x0 = np.stack([radius * np.cos(ang), radius * np.sin(ang), ang + np.pi], axis=1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        x0[:, :2] += rng.uniform(-jitter, jitter, size=(B, 2))
        x0[:, 2] += rng.uniform(-3 * jitter, 3 * jitter, size=B)
    goal = np.stack(
        [radius * np.cos(ang + np.pi), radius * np.sin(ang + np.pi), ang + np.pi], axis=1
    )
    thetas = jax.vmap(problem.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.zeros((B,) + problem.default_u0.shape)
    return thetas, U0


def grid_swap_swarm(problem, side: int = 32, pitch: float = 2.0, seed: int = 0):
    """Warehouse-reshuffle scenario at fleet scale: side x side robots on a
    grid, each trading places with its horizontal partner — side^2/2
    simultaneous head-on exchanges in a shared crowd. The canonical
    swarm-avoidance workload."""
    if side % 2:
        raise ValueError("side must be even (disjoint horizontal pairs)")
    B = side * side
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    cells = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(float) * pitch
    starts = cells + rng.uniform(-0.15, 0.15, cells.shape)
    partner = np.arange(B).reshape(side, side // 2, 2)[..., ::-1].reshape(B)
    x0 = np.c_[starts, rng.uniform(-np.pi, np.pi, (B, 1))]
    goal = np.c_[starts[partner], rng.uniform(0, 2 * np.pi, (B, 1))]
    thetas = jax.vmap(problem.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.zeros((B,) + problem.default_u0.shape)
    return thetas, U0


def random_fleet(problem, B: int, seed: int = 0, spread: float = 1.2):
    """A (start, goal) scenario bank on open floor."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate(
        [rng.uniform(-0.3, 0.3, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    goal = np.concatenate(
        [rng.uniform(-spread, spread, size=(B, 2)), rng.uniform(0, 2 * np.pi, size=(B, 1))],
        axis=1,
    )
    thetas = jax.vmap(problem.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.zeros((B,) + problem.default_u0.shape)
    return thetas, U0
