"""Device-mesh helpers for batch-of-volumes scaling.

The reference is single-process/single-node (SURVEY.md §2.11); this is
the scaling layer: a ('data', 'space') Mesh where 'data' shards the
batch of series and 'space' shards the volume z-axis, with XLA
inserting the collectives (gathers across 'space' for resample, psum
for registration reductions). Every device reaches every other at the
same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "volume_sharding", "batch_sharding",
           "replicated_sharding", "initialize_distributed"]


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host hook: initialize jax.distributed so make_mesh spans
    hosts. No-op when
    the env provides no coordinator (single-host)."""
    import os
    if coordinator_address is None:
        coordinator_address = os.environ.get("MIA_COORDINATOR")
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def make_mesh(n_devices=None, space=1, devices=None):
    """('data', 'space') mesh; `space` shards the volume z-axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % space != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by "
                         f"space {space}")
    arr = np.asarray(devices).reshape(n_devices // space, space)
    return Mesh(arr, axis_names=("data", "space"))


def volume_sharding(mesh):
    """(B, Z, Y, X) volumes: batch over 'data', z over 'space'."""
    return NamedSharding(mesh, P("data", "space", None, None))


def batch_sharding(mesh):
    """(B, ...) per-series quantities: batch over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())
