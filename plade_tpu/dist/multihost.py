"""Multi-host process-group setup and cross-host batch orchestration.

The reference has no distributed story at all (SURVEY section 2.3); this
module is the cross-host layer of the mesh design: N hosts each drive
their local devices, the pairs axis shards globally, and only the small
RegistrationResult pytrees travel cross-host.

Usage on each host (under a launcher that sets the standard JAX env
vars):

    from plade_tpu.dist import multihost
    multihost.initialize()                 # jax.distributed across hosts
    mesh = multihost.global_mesh(intra=1)  # (pairs, intra) over ALL devices
    results = mesh_mod.register_batch(tgt_b, src_b, keys, cfg, mesh)

With `jax.make_array_from_process_local_data` each host feeds only its
own shard of the pairs axis; XLA/GSPMD handles the collectives inside a
pair (intra axis) and no cross-pair communication exists by construction.
"""
from __future__ import annotations

import os

import jax
import numpy as np

from . import mesh as mesh_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); with none of them set the run is
    single-process.  Returns True when a
    multi-process group was initialized, False for single-process runs
    (everything keeps working on the local devices).
    """
    num = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1 and coordinator_address is None and \
            "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return True


def global_mesh(intra: int = 1) -> "jax.sharding.Mesh":
    """(pairs, intra) mesh spanning every chip of every host."""
    return mesh_mod.make_mesh(len(jax.devices()), intra=intra)


def local_batch_to_global(mesh, local_tgt, local_src, local_keys):
    """Assemble globally-sharded batch arrays from per-host local shards.

    Each host passes its own pairs (leading axis = global_batch /
    num_processes).  Returns pytrees of jax.Arrays sharded over the
    ``pairs`` mesh axis, suitable for mesh_mod.register_batch.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    def assemble(spec_tree, local_tree):
        def one(spec, local):
            sharding = NamedSharding(mesh, spec)
            global_shape = (local.shape[0] * jax.process_count(),) + \
                local.shape[1:]
            return jax.make_array_from_process_local_data(
                sharding, np.asarray(local), global_shape)
        return jax.tree.map(one, spec_tree, local_tree,
                            is_leaf=lambda x: isinstance(x, P))

    tgt_spec, src_spec, key_spec = mesh_mod.batch_specs(None)
    return (assemble(tgt_spec, local_tgt),
            assemble(src_spec, local_src),
            assemble(key_spec, local_keys))
