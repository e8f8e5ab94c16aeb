"""Device mesh + shardings — the communication backend of this framework.

The reference's only parallelism is single-process ``nn.DataParallel``
(``trainer.py:37-38``); its replacement here is a 1-D ``data`` mesh over
all devices with:

  * the batch sharded along ``data`` (inputs arrive pre-sharded via
    ``jax.device_put`` with a NamedSharding — no scatter step);
  * parameters and optimizer state replicated;
  * gradient all-reduce inserted by XLA (over NVLink on a multi-GPU host)
    when the jitted train step consumes sharded batches and produces
    replicated grads.

The model is 24M params, so pure DP is the right point in the
TP/PP/DP design space (SURVEY.md §2.7); wider meshes (e.g. ``(data, model)``)
are supported by passing a 2-D shape, the batch axis stays ``data``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: int | None = None, axis_names=("data",)) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"make_mesh({num_devices}) but only {len(devices)} device(s) "
                f"are visible: {devices}. A silently smaller mesh would make "
                "multi-chip runs meaningless — fix the backend/device count."
            )
        devices = devices[:num_devices]
    shape = (len(devices),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("pass a 1-D axis_names or construct the Mesh directly")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def make_mesh_for_batch(batch_size: int, axis_names=("data",)) -> Mesh:
    """1-D data mesh over the largest device count that divides the batch
    (a 4-sample batch on an 8-device host uses 4 devices rather than fail)."""
    n = jax.device_count()
    while n > 1 and batch_size % n:
        n -= 1
    return make_mesh(n, axis_names)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim across the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def replicate(tree, sharding: NamedSharding):
    """Replicate a pytree of host arrays onto a (possibly multi-host) mesh.

    Single-process: plain sharded device_put. Multi-process: every host holds
    the full value (same seed / same checkpoint), so each host's copy becomes
    its addressable shards of one fully-replicated global array."""
    if jax.process_count() > 1:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)),
            tree,
        )
    return jax.device_put(tree, sharding)


def multihost_barrier(name: str = "barrier") -> None:
    """Synchronize all hosts of a multi-process run (no-op single-process).

    Used at trainer epoch boundaries so checkpoint writes and loader epoch
    advances stay in lockstep across hosts of a pod (SURVEY §2.7)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def process_shard_info() -> tuple[int, int]:
    """(shard_index, num_shards) for per-host dataset sharding."""
    return jax.process_index(), jax.process_count()


def shard_batch(batch: dict, sharding: NamedSharding) -> dict:
    """device_put numpy arrays in a batch dict with the batch sharding."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = jax.device_put(v, sharding)
        else:
            out[k] = v
    return out
