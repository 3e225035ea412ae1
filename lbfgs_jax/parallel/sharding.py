"""Device-mesh sharding for the giant-vector regime.

The reference has no distributed code (single-address-space Rust,
SURVEY.md §2.3); this module realizes the scaling axis the workload
actually has: the parameter-vector length n, sharded 1-D over a
``jax.sharding.Mesh``.  Every per-iteration op is O(m·n) streaming and
shard-local; the only cross-shard traffic is the dot-product reductions,
which XLA lowers to ``psum``-style all-reduces over ICI (and DCN across
hosts).  With the compact two-loop (``solver.two_loop_compact``) an entire
iteration needs ONE collective round for all 2m+2 reductions.

Usage::

    mesh = make_mesh()                       # all local devices, axis "shard"
    x0 = shard_vector(x0, mesh)              # NamedSharding(P("shard"))
    report = lbfgs().minimize(x0, objective) # GSPMD partitions the step

Multi-host: call ``jax.distributed.initialize()`` first (one process per
host); ``make_mesh`` then spans the global device set.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up: one process per host over DCN.

    Thin wrapper over ``jax.distributed.initialize`` (coordinator address,
    process count and index are passed explicitly, or come from the
    cluster environment where JAX detects one).  After
    this, ``make_mesh()`` spans the global device set and shardings/
    collectives ride ICI within a slice and DCN across hosts.
    """
    jax.distributed.initialize(**kwargs)


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis_name,))


def vector_sharding(mesh: Mesh, axis_name: str = AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_vector(x: Array, mesh: Mesh, axis_name: str = AXIS) -> Array:
    """Place a [n] vector with its leading axis sharded over the mesh.

    n must be divisible by the mesh size for an even layout (pad upstream
    if needed; the solver is padding-agnostic as long as the objective is).
    """
    return jax.device_put(x, vector_sharding(mesh, axis_name))


def state_shardings(mesh: Mesh, state, n: int, axis_name: str = AXIS):
    """Sharding pytree for a ``SolverState``: [n] vectors and the history
    stacks sharded on the n axis, [m] scalar stacks and scalars replicated.

    The history is stored ring-major [m, n/128, 128] when n is
    lane-aligned (``core.hist_store_shape``); its row axis carries the
    vector sharding there (the 128-lane minor axis stays local)."""

    def spec(leaf):
        if leaf.ndim == 1 and leaf.shape[0] == n:
            return NamedSharding(mesh, P(axis_name))
        if leaf.ndim == 2 and leaf.shape[1] == n:
            return NamedSharding(mesh, P(None, axis_name))
        if leaf.ndim == 3 and leaf.shape[1] * leaf.shape[2] == n:
            # hist_store_shape only goes ring-major when rows divides
            # the device count; guard anyway for states built under a
            # different device configuration
            if leaf.shape[1] % mesh.devices.size == 0:
                return NamedSharding(mesh, P(None, axis_name, None))
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P())

    import jax.tree_util as jtu

    return jtu.tree_map(spec, state)
