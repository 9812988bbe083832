"""Multi-host initialization and helpers.

The reference is strictly single-process (SURVEY.md §5.8).  This module
wraps ``jax.distributed`` for multi-host runs: initialize once per
process, build meshes spanning all hosts, and keep collective-friendly
shardings (the interconnect is XLA's concern once the mesh is laid out
over ``jax.devices()``).
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX.

    Pass the coordinator address, process count and process id
    explicitly: nothing on a GPU host announces a cluster.  Safe to call once per
    process before any computation.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous shard of a globally-sharded batch axis."""
    per = global_batch // jax.process_count()
    if per * jax.process_count() != global_batch:
        raise ValueError(
            f"global batch {global_batch} must divide process count "
            f"{jax.process_count()}"
        )
    start = per * jax.process_index()
    return slice(start, start + per)


def assemble_global_batch(local_arrays, mesh, spec):
    """Build a global jax.Array from per-host local shards
    (``jax.make_array_from_process_local_data``)."""
    sharding = jax.sharding.NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_arrays)
