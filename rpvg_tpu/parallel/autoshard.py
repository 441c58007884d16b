"""In-process data-parallel sharding of the batched device dispatches.

The production drivers (batched EM, diploid pair scoring, the Gibbs
samplers) operate on padded (B, ...) cluster stacks where every cluster
is independent — the reference's dynamic `omp parallel for` over
size-sorted clusters (/root/reference/src/main.cpp:827-998) maps onto a
1-axis data mesh by sharding that leading batch axis.  When more than
one JAX device is visible, :func:`shard_batched` places each stack with
its batch axis split across the mesh before the jitted kernel runs, so
XLA SPMD-partitions the computation with no collectives (per-cluster
reductions never cross the batch axis).  Per-cluster math is unchanged,
and the kernels sum in a fixed order (backend.fixed_order_sum) rather
than in whatever order the compiler picks for the smaller per-device
batch, so outputs stay byte-identical to the single-device run: pinned
by tests/test_mesh.py on a forced 8-device CPU mesh, and by
chip_smoke.py --four-cards on four GPUs.

Chunks whose batch size does not divide the mesh stay on the default
device — the dispatch sites pad batch axes to powers of two, so only
the smallest (latency-bound) chunks opt out.  RPVG_TPU_AUTOSHARD=0
disables the mesh entirely.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np


@lru_cache(maxsize=1)
def data_mesh():
    """1-axis ("data") mesh over every visible device; None when a
    single device is visible or RPVG_TPU_AUTOSHARD=0."""
    if os.environ.get("RPVG_TPU_AUTOSHARD", "1") == "0":
        return None
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if len(devices) < 2:
        return None
    return Mesh(np.array(devices), axis_names=("data",))


def num_data_shards() -> int:
    mesh = data_mesh()
    return 1 if mesh is None else int(mesh.devices.size)


def shard_batched(*arrays):
    """device_put each (B, ...) array with the leading axis sharded over
    the data mesh; unchanged when no mesh exists or B doesn't divide it
    (all-or-nothing across the argument list so every operand of one
    kernel shares a layout)."""
    mesh = data_mesh()
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    n = int(mesh.devices.size)
    if any(a.shape[0] % n != 0 for a in arrays):
        return arrays if len(arrays) > 1 else arrays[0]
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = tuple(
        jax.device_put(
            a, NamedSharding(mesh, P("data", *([None] * (a.ndim - 1))))
        )
        for a in arrays
    )
    return out if len(out) > 1 else out[0]
