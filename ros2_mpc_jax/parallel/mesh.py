"""Device-mesh scaling for the scenario-batched solver.

The reference has no parallelism of any kind — one Python process per ROS
node, one IPOPT solve per tick (SURVEY.md §2). The scaling model here
(BASELINE.json "north_star") is:

* **batch axis**: thousands of (start, goal, obstacle-layout) scenario
  solves per device;
* **mesh axis**: the scenario bank sharded over a named
  ``jax.sharding.Mesh`` via ``jit`` shardings (GSPMD); summary telemetry
  (mean cost, convergence fraction, max KKT residual) is reduced with XLA
  collectives. On one host with four NVLink-connected GPUs every card
  reaches every other at the same rate, so the mesh follows the algorithm
  alone: one ``"scenario"`` axis;
* **multi-host**: ``jax.distributed.initialize`` + the same program — GSPMD
  makes the per-host code identical.

MPC solves are embarrassingly parallel across scenarios, and the tiny 3x2
matrices leave nothing to gain from intra-solve tensor sharding. A 2D
``("host", "chip")`` layout is available for sweeps spanning several hosts.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SCENARIO_AXIS) -> Mesh:
    """1D mesh over the first ``n_devices`` (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_host_chip_mesh(n_hosts: int, chips_per_host: int) -> Mesh:
    """2D (host, chip) mesh for runs spanning several hosts: scenarios
    shard over both axes, and host-crossing collectives stay on the outer
    axis."""
    devices = np.asarray(jax.devices()[: n_hosts * chips_per_host]).reshape(
        n_hosts, chips_per_host
    )
    return Mesh(devices, ("host", "chip"))


def bank_metrics(sols) -> dict:
    """Scalar telemetry reduced across the whole bank — under pjit these
    ``mean``/``max`` lower to XLA all-reduces over the mesh."""
    return {
        "mean_cost": jnp.mean(sols.cost),
        "max_kkt": jnp.max(sols.kkt_residual),
        "frac_converged": jnp.mean(sols.converged.astype(jnp.float32)),
    }


def make_bank_solver(
    problem,
    mesh: Mesh,
    axis_names=None,
    engine: str = "vmap",
    **engine_opts,
):
    """Jit a scenario-bank solve sharded over ``mesh``.

    Returns ``step(thetas, U0s) -> (Solution batch, metrics)`` where every
    leaf of ``thetas``/``U0s`` has a leading scenario axis divisible by the
    mesh size. Solutions stay sharded (device-resident for the next
    warm-started tick); metrics are replicated scalars.

    Engines:

    * ``'vmap'`` — the reference engine (solver/ilqr.py), partitioned by
      GSPMD from the in/out shardings alone.
    * ``'fast'`` — the lane-aligned bank engine (solver/batched.py),
      model-generic over small (n, m) OCPs: the unicycle families AND the
      ext families (bicycle, smooth, quadrotor) all run at bank throughput.
      On a multi-device mesh it is wrapped in ``shard_map`` so its internal
      ``(B/lanes, lanes)`` reshape happens per shard — GSPMD would otherwise
      have to reshard the lane-minor layout across devices. Per-device batch
      must be a multiple of ``lanes`` (default 128).
    * ``'pallas'`` — the whole-solver kernels (solver/pallas_kernel.py),
      likewise ``shard_map``-wrapped: each device runs the kernel over its
      local scenario blocks. Per-device batch must be a multiple of
      ``tile_s * tile_l``. Compiled on the GPU, interpreted on the CPU
      (:func:`~ros2_mpc_jax.solver.pallas_kernel.pallas_interpret`).
    * ``'mppi'`` — the sampling engine (solver/mppi.py): derivative-free
      path-integral search, vmapped and GSPMD-partitioned like 'vmap'.
      Per-scenario PRNG keys are derived inside the jit by folding the
      global scenario index into ``seed`` (an ``engine_opts`` int, default
      0) — deterministic and shard-layout-independent.
    * ``'hybrid'`` — MPPI exploration seeding the iLQR polish
      (solver/mppi.py::make_hybrid_solver); same key derivation.
    * ``'multistart'`` — one batched iLQR polish over {warm start, MPPI
      elite, deterministic arc seeds}, best-of by (converged, cost)
      (solver/mppi.py::make_multistart_solver); breaks symmetric saddles
      sampling alone cannot.
    * ``'two_pass'`` — the production straggler rescue
      (solver/rescue.py::make_pallas_two_pass_point_stab): Pallas first
      pass + compacted cold/warm long-schedule re-solve of the
      non-converged tail, per shard, one jit. Point-stabilization kinds
      only. Opts: ``capacity=`` (per-shard), ``rescue_settings=``, tiles.
    * ``'multistart_bank'`` — basin escape at bank-engine throughput
      (solver/multistart_bank.py): K arc-seed starts per scenario reshaped
      into the batch, per-shard. Opts: ``swing_fracs=``, ``inner_engine=``
      (the bank engine doing the polish: 'pallas' | 'fast' | 'vmap'),
      tiles/lanes.
    * ``'multistart_rescue'`` — the composed robustness mode
      (solver/rescue.py::make_multistart_two_pass_solver): arc-seeded
      multistart first pass + compacted cold/warm long-schedule multistart
      rescue of the non-converged tail, one jit per shard. Opts:
      ``capacity=`` (per-shard), ``swing_fracs=``, ``rescue_settings=``,
      ``inner_engine=``, tiles.

    Extra ``engine_opts`` are forwarded to the engine factory
    (``lanes=`` for 'fast'; ``tile_s=``, ``tile_l=`` for
    'pallas'; ``seed=``, ``settings=MppiSettings(...)`` for 'mppi'/'hybrid').
    """
    if axis_names is None:
        axis_names = tuple(mesh.axis_names)
    batch_spec = P(axis_names)
    shard = NamedSharding(mesh, batch_spec)
    replicate = NamedSharding(mesh, P())

    kind = getattr(problem, "kind", "point_stabilization")
    if engine == "pallas" and kind not in (
        "point_stabilization", "tracking", "legacy",
    ):
        raise ValueError(
            f"engine='pallas' hard-codes the reference unicycle structure; "
            f"problem kind {kind!r} (model-generic family) runs at bank "
            "throughput via engine='fast' (the generic lane-aligned engine) "
            "or via 'vmap' | 'mppi' | 'hybrid' | 'multistart'"
        )
    if engine in ("two_pass", "multistart_bank", "multistart_rescue") and kind not in (
        "point_stabilization", "legacy",
    ):
        raise ValueError(
            f"engine='{engine}' composes the point-stabilization bank "
            f"kernels; problem kind {kind!r} needs another engine"
        )
    if engine == "fast":
        from ..solver.batched import make_bank_solver_fast

        batched = make_bank_solver_fast(problem.ocp, problem.settings, **engine_opts)
    elif engine == "pallas":
        # whole-solver kernels; pick by problem shape (tracking theta carries
        # time-varying references)
        from ..solver.pallas_kernel import (
            make_pallas_point_stab_solver,
            make_pallas_tracking_solver,
        )

        if getattr(problem, "kind", "point_stabilization") == "tracking":
            batched = make_pallas_tracking_solver(
                problem.ocp, problem.settings, **engine_opts
            )
        else:
            batched = make_pallas_point_stab_solver(
                problem.ocp, problem.settings, **engine_opts
            )
    elif engine == "two_pass":
        from ..solver.rescue import make_pallas_two_pass_point_stab

        batched = make_pallas_two_pass_point_stab(
            problem.ocp, problem.settings, **engine_opts
        )
    elif engine == "multistart_bank":
        from ..solver.multistart_bank import make_bank_multistart_solver

        inner = engine_opts.pop("inner_engine", "pallas")
        batched = make_bank_multistart_solver(
            problem.ocp, problem.settings, engine=inner, **engine_opts
        )
    elif engine == "multistart_rescue":
        from ..solver.rescue import make_multistart_two_pass_solver

        inner = engine_opts.pop("inner_engine", "pallas")
        batched = make_multistart_two_pass_solver(
            problem.ocp, problem.settings, engine=inner, **engine_opts
        )
    elif engine in ("mppi", "hybrid", "multistart"):
        from ..solver.mppi import (
            MppiSettings,
            make_hybrid_solver,
            make_mppi_solver,
            make_multistart_solver,
        )

        seed = engine_opts.pop("seed", 0)
        mppi_settings = engine_opts.pop("settings", None)
        if engine_opts:
            raise ValueError(
                f"engine='{engine}' takes seed=/settings=, got {sorted(engine_opts)}"
            )
        if engine == "mppi":
            solve1 = make_mppi_solver(
                problem.ocp, mppi_settings or MppiSettings()
            )
        elif engine == "multistart":
            solve1 = make_multistart_solver(
                problem.ocp, problem.settings, mppi_settings
            )
        else:
            solve1 = make_hybrid_solver(
                problem.ocp, problem.settings, mppi_settings
            )
        key0 = jax.random.PRNGKey(seed)

        def batched(thetas, U0s, _solve=jax.vmap(solve1)):
            # fold the GLOBAL scenario index into the key: under pjit the
            # iota is partitioned with the batch, so per-scenario streams
            # are independent of the mesh layout
            idx = jnp.arange(U0s.shape[0], dtype=jnp.uint32)
            keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key0, idx)
            return _solve(thetas, U0s, keys)

    elif engine == "vmap":
        if engine_opts:
            raise ValueError(
                f"engine='vmap' takes no engine_opts, got {sorted(engine_opts)}"
            )
        batched = jax.vmap(problem.solve)
    else:
        raise ValueError(
            f"unknown engine {engine!r}; expected "
            "'vmap' | 'fast' | 'pallas' | 'mppi' | 'hybrid' | 'multistart' "
            "| 'two_pass' | 'multistart_bank' | 'multistart_rescue'"
        )

    if (
        engine in ("fast", "pallas", "two_pass", "multistart_bank", "multistart_rescue")
        and mesh.size > 1
    ):
        # The scenario axis is embarrassingly parallel: run the engine
        # per-shard so its lane/tile packing never crosses a device
        # boundary. (No collectives inside — telemetry reduces outside.)
        batched = jax.shard_map(
            batched,
            mesh=mesh,
            in_specs=(batch_spec, batch_spec),
            out_specs=batch_spec,
            check_vma=False,
        )

    def _step(thetas, U0s):
        sols = batched(thetas, U0s)
        return sols, bank_metrics(sols)

    return jax.jit(
        _step,
        in_shardings=(shard, shard),
        out_shardings=(shard, replicate),
    )


def shard_bank(tree, mesh: Mesh, axis_names=None):
    """Place a host pytree on the mesh, sharded over the leading axis."""
    if axis_names is None:
        axis_names = tuple(mesh.axis_names)
    sharding = NamedSharding(mesh, P(axis_names))
    return jax.device_put(tree, sharding)
