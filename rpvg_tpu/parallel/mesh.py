"""Device mesh and sharded inference steps.

Parallelism layout (SURVEY §2.3 mapping of the reference's OpenMP
structure onto a device mesh):

* **data axis** — clusters are independent, so padded cluster batches
  shard freely across devices (the reference's dynamic parallel-for over
  clusters, src/main.cpp:829).
* **model axis** — inside one giant cluster, the diplotype pair-scoring
  tensor (R, P, P) shards over its first path axis (the reference's
  serial branch-and-bound loop, src/path_estimator.cpp:420-451).
* The TPM normaliser and fragment-length histogram are the only global
  reductions (src/main.cpp:1029-1057, :203-235) — expressed as psums.

The same code runs on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) for CI and on the GPUs of
one host.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import MATMUL_PRECISION
from ..infer.em import _em_solve_batched


def make_mesh(
    n_devices: Optional[int] = None, data: Optional[int] = None, model: int = 1
) -> Mesh:
    """1-or-2 axis mesh over the first `n_devices` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if data is None:
        data = n_devices // model
    assert data * model == n_devices
    mesh_devices = np.array(devices[:n_devices]).reshape(data, model)
    return Mesh(mesh_devices, axis_names=("data", "model"))


def sharded_em_step(mesh: Mesh, max_em_its: int = 10000, max_rel_em_conv: float = 0.001):
    """Batched EM + TPM partial reduction, data-parallel over the
    cluster-batch axis.  Returns a jitted fn(probs, counts, col_masks,
    inv_eff_lengths) -> (abundance fractions, tpm_normalizer)."""
    batch_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=(batch_sharding, batch_sharding, batch_sharding, batch_sharding),
        out_shardings=(batch_sharding, replicated),
    )
    def step(probs, counts, col_masks, inv_eff_lengths):
        abundances, _, _ = _em_solve_batched(
            probs, counts, col_masks, max_em_its, probs.dtype.type(max_rel_em_conv)
        )
        totals = counts.sum(axis=1)
        # Per-path read counts / effective length, reduced globally:
        # the TPM denominator (a cross-device all-reduce on the mesh).
        path_counts = abundances[:, :-1] * totals[:, None]
        tpm_normalizer = (path_counts * inv_eff_lengths).sum()
        return abundances, tpm_normalizer

    return step


def sharded_diploid_scores(mesh: Mesh):
    """All-pairs diplotype scoring with the pair row-axis sharded over
    the model axis and reads replicated; for giant clusters where the
    (R, P, P) tensor exceeds one device."""
    spec_probs = NamedSharding(mesh, P(None, "model"))
    replicated = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=(spec_probs, replicated, replicated, replicated),
        out_shardings=NamedSharding(mesh, P("model", None)),
    )
    def score(probs, noise, counts, log_freqs):
        half = probs * 0.5
        group = noise[:, None, None] + half[:, :, None] + half[:, None, :]
        logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
        pair_ll = jnp.einsum("r,rij->ij", counts, logs, precision=MATMUL_PRECISION)
        return pair_ll + log_freqs[:, None] + log_freqs[None, :]

    return score


def psum_histogram(mesh: Mesh):
    """Cross-host fragment-length histogram reduction via shard_map +
    explicit psum (each host contributes its local histogram)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P("data", None),
        out_specs=P(),
    )
    def reduce_hist(local_hist):
        return jax.lax.psum(local_hist.sum(axis=0), axis_name="data")

    return reduce_hist


def full_inference_step(mesh: Mesh, max_em_its: int = 1000):
    """One combined multi-chip inference step over a padded cluster
    batch: batched EM (data-parallel), diplotype scoring of the first
    cluster (model-parallel), and the global TPM reduction.  This is the
    end-to-end device computation the pipeline executes per bucket."""
    em = sharded_em_step(mesh, max_em_its=max_em_its)
    diploid = sharded_diploid_scores(mesh)

    def step(probs, counts, col_masks, inv_eff_lengths, noise, log_freqs):
        abundances, tpm = em(probs, counts, col_masks, inv_eff_lengths)
        pair_ll = diploid(probs[0][:, :-1], noise, counts[0], log_freqs)
        return abundances, tpm, pair_ll

    return step
