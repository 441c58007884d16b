"""Gibbs read-count sampler: posterior read-count allocations per path
via binomial thinning + Dirichlet(gamma) resampling (reference
gibbsReadCountSampler, /root/reference/src/path_abundance_estimator.cpp:116-212).

Expressed as a JAX scan: the per-row sequential binomial thinning over
columns is exactly a multinomial split, vectorised across all rows.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..constants import MIN_GIBBS_ABUNDANCE


def _multinomial_rows(key, n, p):
    """Sample row-wise multinomials by sequential binomial splitting.

    n: (R,) counts; p: (R, C) probabilities summing to <= 1 per row."""
    C = p.shape[1]

    def split(carry, inputs):
        remaining_n, remaining_p = carry
        col_p, col_key = inputs
        ratio = jnp.clip(jnp.where(remaining_p > 0, col_p / remaining_p, 0.0), 0.0, 1.0)
        draw = jax.random.binomial(
            col_key, remaining_n, ratio, dtype=remaining_n.dtype
        )
        return (remaining_n - draw, remaining_p - col_p), draw

    keys = jax.random.split(key, C)
    (_, _), draws = jax.lax.scan(
        split, (n.astype(p.dtype), jnp.ones_like(n, dtype=p.dtype)), (p.T, keys)
    )
    return draws.T  # (R, C)


def _gibbs_read_counts_masked(key, probs, counts, init_fracs, col_mask, gamma, num_samples, thin_its):
    """Returns (num_samples, C) sampled abundance fractions.  col_mask
    zeroes the Dirichlet prior on padded columns so zero-padded inputs
    sample identically to their unpadded shapes' distribution."""

    def iteration(fracs, it_key):
        weighted = probs * fracs[None, :]
        row_sums = backend.fixed_order_sum(weighted, 1)[:, None]
        posteriors = jnp.where(row_sums > 0, weighted / row_sums, 0.0)

        thin_key, gamma_key = jax.random.split(it_key)
        path_counts = backend.fixed_order_sum(
            _multinomial_rows(thin_key, counts, posteriors), 0
        )

        # Explicit dtype: random.gamma otherwise draws at the x64
        # canonical float, breaking the f32 carry of device buffers.
        draws = (
            jax.random.gamma(gamma_key, path_counts + gamma, dtype=fracs.dtype)
            * col_mask
        )
        new_fracs = draws / backend.fixed_order_sum(draws, 0)
        return new_fracs, new_fracs

    keys = jax.random.split(key, num_samples * thin_its)
    _, all_fracs = jax.lax.scan(iteration, init_fracs, keys)
    return all_fracs[thin_its - 1 :: thin_its]


@partial(jax.jit, static_argnames=("num_samples", "thin_its"))
def _gibbs_read_counts(key, probs, counts, init_fracs, gamma, num_samples, thin_its):
    return _gibbs_read_counts_masked(
        key, probs, counts, init_fracs,
        jnp.ones_like(init_fracs), gamma, num_samples, thin_its,
    )


@partial(jax.jit, static_argnames=("num_samples", "thin_its"))
def _gibbs_read_counts_vmapped(keys, probs, counts, init_fracs, col_masks, gamma, num_samples, thin_its):
    """Batch axis over clusters: keys (B,2), probs (B,R,C), counts
    (B,R), init_fracs/col_masks (B,C)."""
    return jax.vmap(
        _gibbs_read_counts_masked, in_axes=(0, 0, 0, 0, 0, None, None, None)
    )(keys, probs, counts, init_fracs, col_masks, gamma, num_samples, thin_its)


def gibbs_read_count_samples(
    probs: np.ndarray,
    counts: np.ndarray,
    abundances: np.ndarray,
    noise_count: float,
    total_count: float,
    rng_key,
    num_samples: int,
    thin_its: int = 25,
    gamma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample posterior read counts given EM point estimates.

    Returns (noise_samples (S,), abundance_samples (S, P)); sub-threshold
    abundances fold into the noise sample (reference :192-210).

    On CPU backends the C++ sampler runs (the same per-job stream the
    batched sweep uses, so per-cluster and batched calls agree)."""
    if _native_gibbs_enabled():
        [(noise_samples, path_samples)] = run_native_gibbs(
            [(probs, counts, abundances, noise_count, total_count)],
            [np.asarray(rng_key)],
            int(num_samples),
            int(thin_its),
            gamma,
        )
        return noise_samples, path_samples

    init_fracs = np.concatenate([abundances / total_count, [noise_count / total_count]])

    fracs = np.asarray(
        _gibbs_read_counts(
            rng_key,
            jnp.asarray(probs),
            jnp.asarray(counts),
            jnp.asarray(init_fracs, dtype=jnp.asarray(probs).dtype),
            float(gamma),
            int(num_samples),
            int(thin_its),
        ),
        dtype=np.float64,
    )

    sampled_counts = fracs * total_count
    path_samples = sampled_counts[:, :-1].copy()
    noise_samples = sampled_counts[:, -1].copy()
    low = fracs[:, :-1] < MIN_GIBBS_ABUNDANCE
    noise_samples += np.where(low, path_samples, 0.0).sum(axis=1)
    path_samples[low] = 0.0
    return noise_samples, path_samples


def _fold_low_abundance(fracs, total):
    """Shared tail: scale sampled fractions to counts and fold
    sub-threshold paths into the noise sample (reference :192-210)."""
    sampled = fracs * total
    path_samples = sampled[:, :-1].copy()
    noise_samples = sampled[:, -1].copy()
    low = fracs[:, :-1] < MIN_GIBBS_ABUNDANCE
    noise_samples += np.where(low, path_samples, 0.0).sum(axis=1)
    path_samples[low] = 0.0
    return noise_samples, path_samples


def run_native_gibbs(cluster_inputs, rng_keys, num_samples, thin_its, gamma=1.0):
    """CPU speed path: the C++ sampler runs each job's chain with an
    mt19937_64 stream seeded from its JAX key (distribution-preserving
    — the JAX and reference samplers draw different bits too; batching
    and prefix-slicing padded chains are bitwise stable because jobs
    are independent sequential streams).  Same input/output contract as
    the jitted sweep."""
    import ctypes
    import os

    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.array([item[0].shape[0] for item in cluster_inputs], dtype=np.int64)
    n_cols = np.array([item[0].shape[1] for item in cluster_inputs], dtype=np.int64)
    # num_samples: one count per job, or a scalar for all — sequential
    # mt19937 streams make a shorter run the exact prefix of a longer
    # one, so per-job exact counts save the padded draws.
    if np.ndim(num_samples) == 0:
        samples_arr = np.full(n, int(num_samples), dtype=np.int64)
    else:
        samples_arr = np.asarray(num_samples, dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(samples_arr * n_cols, out=out_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(item[0], dtype=np.float64).ravel() for item in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(item[1], dtype=np.float64) for item in cluster_inputs]
    )
    fracs_concat = np.concatenate(
        [
            np.concatenate(
                [np.asarray(item[2], dtype=np.float64) / item[4], [item[3] / item[4]]]
            )
            for item in cluster_inputs
        ]
    )
    seeds = np.array(
        [
            (np.uint64(np.asarray(key).astype(np.uint64)[0]) << np.uint64(32))
            | np.uint64(np.asarray(key).astype(np.uint64)[1])
            for key in rng_keys
        ],
        dtype=np.uint64,
    )
    out = np.empty(int(out_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_gibbs_ragged(
        as_f64(probs_concat), as_f64(counts_concat), as_f64(fracs_concat),
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        as_i64(mat_offsets), as_i64(row_offsets), as_i64(col_offsets),
        as_i64(out_offsets), as_i64(n_rows), as_i64(n_cols), as_i64(samples_arr),
        n, int(thin_its), float(gamma), int(min(16, os.cpu_count() or 1)),
        as_f64(out),
    )

    results = []
    for i, item in enumerate(cluster_inputs):
        C = int(n_cols[i])
        fracs = out[out_offsets[i] : out_offsets[i + 1]].reshape(int(samples_arr[i]), C)
        results.append(_fold_low_abundance(fracs, item[4]))
    return results


def _native_gibbs_enabled() -> bool:
    import os

    if backend.device_enabled():
        return False
    if os.environ.get("RPVG_TPU_NATIVE_EM", "1") == "0":
        return False
    try:
        from ..native import load_library

        return load_library() is not None
    except Exception:
        return False


def run_batched_gibbs(
    cluster_inputs,
    rng_keys,
    num_samples: int,
    thin_its: int = 25,
    gamma: float = 1.0,
    dtype=None,
    max_bucket_rows: int = 4096,
):
    """Sample read-count posteriors over many clusters with the same
    shape bucketing as run_batched_em, so the whole Gibbs pass compiles
    O(#buckets) programs instead of one per cluster shape.

    cluster_inputs: per cluster (noise-normalised probs (R, P+1), counts
    (R,), abundances (P,), noise_count, total_count); rng_keys: one JAX
    PRNG key per cluster (ClusterRNG parity with the per-cluster path).
    Returns per cluster (noise_samples (S,), path_samples (S, P)).

    Draws match the per-cluster sampler bitwise at equal dtype: the
    threefry PRNG is counter-based (bits[i] = hash(key, i)), so the
    first R/C elements of every padded draw equal the unpadded draw,
    and padded rows/columns contribute zero through the mask.
    """
    if _native_gibbs_enabled():
        backend.count_work("gibbs", False, len(cluster_inputs))
        return run_native_gibbs(cluster_inputs, rng_keys, num_samples, thin_its, gamma)

    from .batching import _ceil_pow2, _ceil_pow4, hybrid_host_indices

    # On an accelerator, clusters below the EM hybrid cutoff sample on
    # the native host sampler too, so a cluster's EM and its sampler
    # run on the same engine.
    results = [None] * len(cluster_inputs)
    host_idx = hybrid_host_indices([item[0] for item in cluster_inputs])
    if host_idx:
        backend.count_work("gibbs", False, len(host_idx))
        host_results = run_native_gibbs(
            [cluster_inputs[idx] for idx in host_idx],
            [rng_keys[idx] for idx in host_idx],
            num_samples if np.ndim(num_samples) == 0
            else [num_samples[idx] for idx in host_idx],
            thin_its, gamma,
        )
        for idx, result in zip(host_idx, host_results):
            results[idx] = result
    host_set = set(host_idx)
    device_idx = [idx for idx in range(len(cluster_inputs)) if idx not in host_set]
    backend.count_work("gibbs", True, len(device_idx))

    per_job = None
    if np.ndim(num_samples) != 0:
        # JAX path: counter-based draws make the padded run's prefix
        # bitwise equal to the exact-size run, so sample the max and
        # slice per job.
        per_job = [int(s) for s in num_samples]
        num_samples = max((per_job[idx] for idx in device_idx), default=0)
        size = 1  # pow2 pad keeps the jit shape population small
        while size < num_samples:
            size *= 2
        num_samples = size

    if dtype is None:
        dtype = backend.device_dtype()

    buckets = {}
    for idx in device_idx:
        R, C = cluster_inputs[idx][0].shape
        buckets.setdefault((_ceil_pow4(R), _ceil_pow2(C)), []).append(idx)

    for (R_pad, C_pad), indices in buckets.items():
        max_batch = max(1, max_bucket_rows // R_pad) * 8
        for chunk_start in range(0, len(indices), max_batch):
            chunk = indices[chunk_start : chunk_start + max_batch]
            B = _ceil_pow2(len(chunk), floor=1)

            probs = np.zeros((B, R_pad, C_pad), dtype=dtype)
            counts = np.zeros((B, R_pad), dtype=dtype)
            init_fracs = np.zeros((B, C_pad), dtype=dtype)
            col_masks = np.zeros((B, C_pad), dtype=dtype)
            keys = np.zeros((B,) + np.asarray(rng_keys[chunk[0]]).shape, dtype=np.uint32)
            for bi, idx in enumerate(chunk):
                p, c, abundances, noise_count, total = cluster_inputs[idx]
                R, C = p.shape
                probs[bi, :R, :C] = p
                counts[bi, :R] = c
                init_fracs[bi, :C] = np.concatenate(
                    [np.asarray(abundances) / total, [noise_count / total]]
                )
                col_masks[bi, :C] = 1.0
                keys[bi] = np.asarray(rng_keys[idx])

            from ..parallel.autoshard import shard_batched

            fracs = np.asarray(
                _gibbs_read_counts_vmapped(
                    *shard_batched(
                        jnp.asarray(keys),
                        jnp.asarray(probs),
                        jnp.asarray(counts),
                        jnp.asarray(init_fracs),
                        jnp.asarray(col_masks),
                    ),
                    float(gamma),
                    int(num_samples),
                    int(thin_its),
                ),
                dtype=np.float64,
            )

            for bi, idx in enumerate(chunk):
                C = cluster_inputs[idx][0].shape[1]
                total = cluster_inputs[idx][4]
                cluster_fracs = fracs[bi, :, :C]
                sampled = cluster_fracs * total
                path_samples = sampled[:, :-1].copy()
                noise_samples = sampled[:, -1].copy()
                low = cluster_fracs[:, :-1] < MIN_GIBBS_ABUNDANCE
                noise_samples += np.where(low, path_samples, 0.0).sum(axis=1)
                path_samples[low] = 0.0
                if per_job is not None:
                    noise_samples = noise_samples[: per_job[idx]]
                    path_samples = path_samples[: per_job[idx]]
                results[idx] = (noise_samples, path_samples)

    return results
