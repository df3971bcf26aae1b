"""Multi-host distribution scaffolding.

The reference is a single-process, single-GPU program (SURVEY.md §5.8);
this layer is new: `jax.distributed` initialization, a global mesh
whose `limb` axis spans every device in the job (NVLink within a host,
the network across hosts), host-collective gather/scatter for register
exchange, and primary-gated checkpoint writes.

Entry points:
  * init_from_env()  — called by the CLI before any jax usage when the
    PRMERS_COORDINATOR / PRMERS_NUM_PROCS / PRMERS_PROC_ID env vars are
    set (mirrors how the reference selects its device with -d, here
    extended to a whole process group).
  * global_gather(arr) — a (possibly non-addressable) globally-sharded
    array -> full numpy on EVERY host.
  * put_global(host_array, mesh, spec) — host value -> globally sharded
    device array (each process contributes its addressable shards).
"""

from __future__ import annotations

import os

import numpy as np

_INITIALIZED = False


def init_from_env() -> bool:
    """Initialize jax.distributed from PRMERS_* env vars; returns True if
    a multi-process group was joined. Must run before first jax use."""
    global _INITIALIZED
    coord = os.environ.get("PRMERS_COORDINATOR")
    nproc = os.environ.get("PRMERS_NUM_PROCS")
    if not coord or not nproc or int(nproc) <= 1:
        return False
    import jax
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(os.environ.get("PRMERS_PROC_ID", "0")))
    _INITIALIZED = True
    return True


def is_primary() -> bool:
    try:
        import jax
        return jax.process_index() == 0
    except Exception:
        return True


def process_count() -> int:
    try:
        import jax
        return jax.process_count()
    except Exception:
        return 1


def barrier(tag: str = "prmers") -> None:
    if process_count() <= 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(tag)


def global_gather(arr) -> np.ndarray:
    """Globally-sharded jax array -> full numpy value on every host."""
    import jax
    if jax.process_count() <= 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    # replicate across the mesh, then read the addressable copy
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def put_global(host_array: np.ndarray, mesh, spec):
    """Host numpy value -> device array sharded over a (possibly
    multi-host) mesh; every process passes the SAME full host value and
    contributes its addressable shards."""
    import jax
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() <= 1:
        return jax.device_put(host_array, sharding)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])
