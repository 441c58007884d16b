"""Haplotype group posterior engines.

Three engines over the (R, P) probability matrix + noise column:

* :func:`path_group_posteriors_full` — exhaustive enumeration of path
  multisets of the ploidy size (reference calculatePathGroupPosteriorsFull,
  /root/reference/src/path_estimator.cpp:332-377).
* :func:`path_group_posteriors_diploid` — dense all-pairs scoring for
  ploidy 2 expressed as blocked (R, P, P) log-likelihood tensors with
  threshold masking.  This replaces the reference's serial
  branch-and-bound (calculatePathGroupPosteriorsBounded, :379-473) with
  a data-parallel computation that provably yields the same posteriors: the
  B&B's pruning bound is conservative, and its final filter (drop
  likelihoods below max * min_rel_likelihood) is re-applied here over
  the exact full set.
* :func:`path_group_posteriors_gibbs` — collapsed Gibbs sampling over
  group slots (reference estimatePathGroupPosteriorsGibbs, :475-589);
  matches distributionally (chain/burn/iteration sizing identical).
"""

from __future__ import annotations

import math
from functools import partial
from itertools import combinations_with_replacement
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    BURN_ITS_SCALING,
    GIBBS_CHAIN_SCALING,
    GIBBS_ITS_SCALING,
    MIN_BURN_ITS,
    MIN_GIBBS_CHAINS,
    MIN_GIBBS_ITS,
)
from .. import backend
from ..mathutils import num_permutations
from .matrices import calc_path_log_frequencies

_LOWEST = -np.finfo(np.float64).max


def _normalize_log_posteriors(log_posteriors: np.ndarray) -> np.ndarray:
    max_lp = log_posteriors.max()
    if not np.isfinite(max_lp):
        return np.full_like(log_posteriors, np.nan)
    shifted = np.exp(log_posteriors - max_lp)
    return shifted / shifted.sum()


def path_group_posteriors_full(
    probs: np.ndarray,
    noise: np.ndarray,
    counts: np.ndarray,
    path_counts: Sequence[int],
    group_size: int,
) -> Tuple[List[List[int]], np.ndarray]:
    """Posterior over every multiset of `group_size` paths."""
    P = probs.shape[1]
    log_freqs = calc_path_log_frequencies(path_counts)

    if group_size == 1:
        # Vectorised marginal case: (R, P) directly.
        with np.errstate(divide="ignore"):
            log_liks = counts @ np.log(noise[:, None] + probs)
        log_liks = log_liks + log_freqs
        groups = [[i] for i in range(P)]
        return groups, _normalize_log_posteriors(log_liks)

    if group_size == 2:
        groups, log_liks = _diploid_log_likelihoods(probs, noise, counts, log_freqs)
        return groups, _normalize_log_posteriors(log_liks)

    groups = [list(c) for c in combinations_with_replacement(range(P), group_size)]
    log_liks = np.empty(len(groups), dtype=np.float64)
    for g, group in enumerate(groups):
        group_probs = noise + probs[:, group].sum(axis=1) / group_size
        with np.errstate(divide="ignore"):
            ll = float(counts @ np.log(group_probs))
        ll += float(log_freqs[list(group)].sum())
        ll += math.log(num_permutations(group))
        log_liks[g] = ll
    return groups, _normalize_log_posteriors(log_liks)


@partial(jax.jit, static_argnames=())
def _diploid_pair_scores(probs, noise, counts, log_freqs):
    """(P, P) log-likelihood matrix of all ordered diplotype pairs."""
    half = probs * 0.5
    # group_probs[r, i, j] = noise[r] + (probs[r,i] + probs[r,j]) / 2
    group = noise[:, None, None] + half[:, :, None] + half[:, None, :]
    logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
    pair_ll = jnp.einsum("r,rij->ij", counts, logs, precision=backend.MATMUL_PRECISION)
    pair_ll = pair_ll + log_freqs[:, None] + log_freqs[None, :]
    return pair_ll


@partial(jax.jit, static_argnames=())
def _diploid_pair_scores_block(probs, noise, counts, log_freqs, half_block, block_log_freqs):
    """Column block of the pair matrix: (P, J) scores against
    half_block (R, J)."""
    half = probs * 0.5
    group = noise[:, None, None] + half[:, :, None] + half_block[:, None, :]
    logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
    pair_ll = jnp.einsum("r,rij->ij", counts, logs, precision=backend.MATMUL_PRECISION)
    return pair_ll + log_freqs[:, None] + block_log_freqs[None, :]


# Memory guard: (R, P, P) tensors above this many elements score in
# column blocks (the reference's giant-cluster branch-and-bound is the
# serial analogue; blocking keeps the dense formulation).
_PAIR_TENSOR_ELEMENT_LIMIT = 1 << 27


def _pair_tensor_limit() -> int:
    """RPVG_TPU_PAIR_TENSOR_LIMIT overrides the giant-cluster element
    guard (the multichip dryrun lowers it so the model-axis-sharded and
    blocked paths execute at toy scale)."""
    import os

    env = os.environ.get("RPVG_TPU_PAIR_TENSOR_LIMIT")
    return int(env) if env else _PAIR_TENSOR_ELEMENT_LIMIT


def _pair_scores_sharded(probs, noise, counts, log_freqs):
    """Model-parallel dense scoring for giant clusters: the pair matrix
    shards over the mesh's model axis (one column/row stripe per
    device), so the (R, P, P) tensor only needs 1/n_devices of a chip's
    memory.  Returns None when the mesh cannot help (single device or
    still too large) or when mesh use is disabled (RPVG_TPU_AUTOSHARD=0,
    the same kill switch the data-parallel batched drivers honor)."""
    import os as _os

    import jax as _jax

    if _os.environ.get("RPVG_TPU_AUTOSHARD") == "0":
        return None
    n_dev = _jax.device_count()
    R, P = probs.shape
    if n_dev <= 1 or R * P * P > _pair_tensor_limit() * n_dev:
        return None

    from ..parallel.mesh import make_mesh, sharded_diploid_scores

    P_pad = ((P + n_dev - 1) // n_dev) * n_dev
    probs_pad = np.zeros((R, P_pad), dtype=probs.dtype)
    probs_pad[:, :P] = probs
    freqs_pad = np.full(P_pad, -np.inf)
    freqs_pad[:P] = log_freqs

    mesh = make_mesh(model=n_dev)
    scores = np.asarray(
        sharded_diploid_scores(mesh)(
            jnp.asarray(probs_pad), jnp.asarray(noise), jnp.asarray(counts),
            jnp.asarray(freqs_pad),
        ),
        dtype=np.float64,
    )
    return scores[:P, :P]


def _pair_scores_blocked(probs, noise, counts, log_freqs):
    R, P = probs.shape
    if R * P * P <= _pair_tensor_limit():
        return np.asarray(
            _diploid_pair_scores(
                jnp.asarray(probs), jnp.asarray(noise), jnp.asarray(counts),
                jnp.asarray(log_freqs),
            ),
            dtype=np.float64,
        )
    sharded = _pair_scores_sharded(probs, noise, counts, log_freqs)
    if sharded is not None:
        return sharded
    block = max(8, _pair_tensor_limit() // max(1, R * P))
    block = _ceil_pow2(block) // 2 or 8
    out = np.empty((P, P), dtype=np.float64)
    probs_dev = jnp.asarray(probs)
    noise_dev = jnp.asarray(noise)
    counts_dev = jnp.asarray(counts)
    freqs_dev = jnp.asarray(log_freqs)
    half = probs * 0.5
    for j0 in range(0, P, block):
        j1 = min(P, j0 + block)
        width = j1 - j0
        # Pad the block to the fixed width so the kernel caches.
        half_block = np.zeros((R, block), dtype=probs.dtype)
        half_block[:, :width] = half[:, j0:j1]
        freqs_block = np.full(block, -np.inf)
        freqs_block[:width] = log_freqs[j0:j1]
        scores = np.asarray(
            _diploid_pair_scores_block(
                probs_dev, noise_dev, counts_dev, freqs_dev,
                jnp.asarray(half_block), jnp.asarray(freqs_block),
            ),
            dtype=np.float64,
        )
        out[:, j0:j1] = scores[:, :width]
    return out


def _ceil_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _ceil_pow4(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 4
    return size


def _diploid_log_likelihoods(probs, noise, counts, log_freqs):
    """All P*(P+1)/2 diplotype log-likelihoods via the dense device
    kernel.  Inputs are zero-padded to power-of-two shapes (padded rows
    get unit noise and zero counts; padded paths -inf prior) so the
    compiled kernel is shared across clusters."""
    R, P = probs.shape
    R_pad, P_pad = _ceil_pow2(R), _ceil_pow2(P)
    probs_pad = np.zeros((R_pad, P_pad), dtype=np.float64)
    probs_pad[:R, :P] = probs
    noise_pad = np.ones(R_pad, dtype=np.float64)
    noise_pad[:R] = noise
    counts_pad = np.zeros(R_pad, dtype=np.float64)
    counts_pad[:R] = counts
    log_freqs_pad = np.full(P_pad, -np.inf)
    log_freqs_pad[:P] = log_freqs

    pair_ll = _pair_scores_blocked(probs_pad, noise_pad, counts_pad, log_freqs_pad)[:P, :P]
    iu = np.triu_indices(P)
    log_liks = pair_ll[iu].copy()
    # Heterozygous pairs carry the 2-permutation prior factor.
    log_liks[iu[0] != iu[1]] += math.log(2.0)
    groups = [[int(i), int(j)] for i, j in zip(*iu)]
    return groups, log_liks


@jax.jit
def _diploid_pair_scores_batched(probs, noise, counts, log_freqs):
    """(B, P, P) pair log-likelihoods for a padded cluster batch."""
    half = probs * 0.5
    group = noise[:, :, None, None] + half[:, :, :, None] + half[:, :, None, :]
    logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
    pair_ll = backend.fixed_order_sum(counts[:, :, None, None] * logs, 1)
    return pair_ll + log_freqs[:, :, None] + log_freqs[:, None, :]


def _diploid_select(pair_ll: np.ndarray, min_rel_likelihood: float):
    """Upper-triangle extraction + permutation prior + relative cutoff
    (shared by the device and native scoring paths)."""
    P = pair_ll.shape[0]
    iu = np.triu_indices(P)
    log_liks = pair_ll[iu].copy()
    log_liks[iu[0] != iu[1]] += math.log(2.0)
    max_ll = log_liks.max()
    keep = log_liks - max_ll >= math.log(min_rel_likelihood)
    groups = [[int(i), int(j)] for i, j, k in zip(iu[0], iu[1], keep) if k]
    return groups, _normalize_log_posteriors(log_liks[keep])


def _native_pair_scores(cluster_inputs):
    """Raw (P, P) pair log-likelihood matrices per cluster through the
    native ragged scorer; None when the library is unavailable."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.array([p.shape[0] for p, _, _, _ in cluster_inputs], dtype=np.int64)
    n_cols = np.array([p.shape[1] for p, _, _, _ in cluster_inputs], dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=out_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _, _, _ in cluster_inputs]
    )
    noise_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, x, _, _ in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, _, x, _ in cluster_inputs]
    )
    lf_concat = np.concatenate(
        [calc_path_log_frequencies(pc) for _, _, _, pc in cluster_inputs]
    )
    out = np.empty(int(out_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_scores_ragged(
        as_f64(probs_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_f64(lf_concat), as_i64(mat_offsets), as_i64(row_offsets),
        as_i64(col_offsets), as_i64(out_offsets), as_i64(n_rows), as_i64(n_cols),
        n, int(min(16, os.cpu_count() or 1)), as_f64(out),
    )

    return [
        out[out_offsets[i] : out_offsets[i + 1]].reshape(int(n_cols[i]), int(n_cols[i]))
        for i in range(n)
    ]


def _diploid_posteriors_native(cluster_inputs, min_rel_likelihood: float):
    """CPU speed path: fused ragged pair scoring + selection +
    normalisation on worker threads (no padding, no shape buckets, no
    per-cluster Python) — identical to scoring then _diploid_select.
    Returns None when the C++ library is unavailable or disabled
    (RPVG_TPU_NATIVE_EM=0 governs the CPU native kernels)."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.fromiter((p.shape[0] for p, _, _, _ in cluster_inputs), np.int64, n)
    n_cols = np.fromiter((p.shape[1] for p, _, _, _ in cluster_inputs), np.int64, n)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    tri = n_cols * (n_cols + 1) // 2
    tri_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(tri, out=tri_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _, _, _ in cluster_inputs]
    )
    noise_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, x, _, _ in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, _, x, _ in cluster_inputs]
    )
    # log frequency priors, segment-normalised in one vectorised pass.
    pc_concat = np.concatenate(
        [np.asarray(pc, dtype=np.float64) for _, _, _, pc in cluster_inputs]
    )
    seg_totals = np.add.reduceat(pc_concat, col_offsets[:-1])
    lf_concat = np.log(pc_concat / np.repeat(seg_totals, n_cols))

    out_nkeep = np.zeros(n, dtype=np.int64)
    out_pairs = np.empty(2 * int(tri_offsets[-1]), dtype=np.int32)
    out_post = np.empty(int(tri_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_posteriors_ragged(
        as_f64(probs_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_f64(lf_concat), as_i64(mat_offsets), as_i64(row_offsets),
        as_i64(col_offsets), as_i64(tri_offsets), as_i64(n_rows), as_i64(n_cols),
        n, float(min_rel_likelihood), int(min(16, os.cpu_count() or 1)),
        as_i64(out_nkeep),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_f64(out_post),
    )

    results = []
    for b in range(n):
        kept = int(out_nkeep[b])
        base = int(tri_offsets[b])
        pairs = out_pairs[2 * base : 2 * (base + kept)].reshape(kept, 2)
        groups = pairs.tolist()
        results.append((groups, out_post[base : base + kept]))
    return results


def diploid_posteriors_batched(
    cluster_inputs,
    min_rel_likelihood: float,
):
    """Diploid posteriors for many clusters at once.

    cluster_inputs: per cluster (probs (R,P), noise (R,), counts (R,),
    path_counts).  Buckets clusters into padded power-of-two shapes so a
    handful of compiled kernels cover the whole population; applies the
    reference's relative-likelihood cutoff per cluster.

    Returns per cluster (group_sets, posteriors)."""
    from typing import List

    if not backend.device_enabled():
        native_results = _diploid_posteriors_native(cluster_inputs, min_rel_likelihood)
        if native_results is not None:
            backend.count_work("diploid", False, len(cluster_inputs))
            return native_results

    # Hybrid routing: tiny clusters' (R, P, P) scoring is bound by
    # per-dispatch latency; run them through the native host kernel
    # WHILE the big buckets' async device chunks are in flight.  The
    # cutoff is not yet measured on the H100;
    # RPVG_TPU_HYBRID_DIPLOID_WORK=0 sends everything to the device.
    import os as _os

    host_idx: List[int] = []
    from .batching import native_em_available

    if native_em_available():
        work_cutoff = int(
            _os.environ.get("RPVG_TPU_HYBRID_DIPLOID_WORK", 1 << 17)
        )
        if work_cutoff > 0:
            host_idx = [
                idx
                for idx, (probs, _, _, _) in enumerate(cluster_inputs)
                if probs.shape[0] * probs.shape[1] * probs.shape[1] < work_cutoff
            ]
    host_set = set(host_idx)

    giant_idx: List[int] = []
    device_idx: List[int] = []
    pair_limit = _pair_tensor_limit()
    for idx, (probs, _, _, _) in enumerate(cluster_inputs):
        if idx in host_set:
            continue
        R, P = probs.shape
        if _ceil_pow4(R) * _ceil_pow2(P) ** 2 > pair_limit:
            # Giant cluster: the padded (B, R, P, P) batched tensor
            # would blow device memory — score it through the
            # per-cluster blocked/model-axis-sharded path instead
            # (_pair_scores_blocked; the reference's analogue is the
            # serial branch-and-bound, src/path_estimator.cpp:379-473).
            giant_idx.append(idx)
        else:
            device_idx.append(idx)

    results = [None] * len(cluster_inputs)
    backend.count_work("diploid", False, len(host_idx))
    backend.count_work("diploid", True, len(cluster_inputs) - len(host_idx))
    pending = dispatch_pair_scores(cluster_inputs, device_idx)

    # Device chunks are in flight; the host kernel fills in the
    # small clusters meanwhile.
    if host_idx:
        host_results = _diploid_posteriors_native(
            [cluster_inputs[idx] for idx in host_idx], min_rel_likelihood
        )
        for idx, result in zip(host_idx, host_results):
            results[idx] = result

    # Giant clusters: per-cluster blocked / model-axis-sharded scoring
    # (still overlapped with the in-flight batched chunks).
    for idx in giant_idx:
        probs, noise, counts, path_counts = cluster_inputs[idx]
        results[idx] = path_group_posteriors_diploid(
            probs, noise, counts, path_counts, min_rel_likelihood
        )

    select_jobs = gather_pair_scores(pending, cluster_inputs)

    native = _native_diploid_select(
        [m for _, m in select_jobs], min_rel_likelihood
    )
    if native is not None:
        for (idx, _), res in zip(select_jobs, native):
            results[idx] = res
    else:
        for idx, scores in select_jobs:
            results[idx] = _diploid_select(scores, min_rel_likelihood)
    return results


def dispatch_pair_scores(cluster_inputs, indices, dtype=None):
    """Enqueue the (P, P) pair log-likelihoods of the indexed clusters
    on the device without blocking: clusters bucket into padded
    (R_pad, P_pad) shapes (padded rows get unit noise and zero counts,
    padded paths a -inf prior) and each chunk is one batched kernel.
    Returns a pending handle for :func:`gather_pair_scores`."""
    from typing import Dict, List, Tuple

    from ..parallel.autoshard import shard_batched

    if dtype is None:
        dtype = backend.device_dtype()
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx in indices:
        R, P = cluster_inputs[idx][0].shape
        buckets.setdefault((_ceil_pow4(R), _ceil_pow2(P)), []).append(idx)
    pending = []
    for (R_pad, P_pad), bucket in buckets.items():
        max_batch = max(1, (1 << 24) // max(1, R_pad * P_pad * P_pad))
        for chunk_start in range(0, len(bucket), max_batch):
            chunk = bucket[chunk_start : chunk_start + max_batch]
            B = _ceil_pow2(len(chunk), floor=1)
            probs_pad = np.zeros((B, R_pad, P_pad), dtype=dtype)
            noise_pad = np.ones((B, R_pad), dtype=dtype)
            counts_pad = np.zeros((B, R_pad), dtype=dtype)
            log_freqs_pad = np.full((B, P_pad), -np.inf, dtype=dtype)
            for b, idx in enumerate(chunk):
                probs, noise, counts, path_counts = cluster_inputs[idx]
                R, P = probs.shape
                probs_pad[b, :R, :P] = probs
                noise_pad[b, :R] = noise
                counts_pad[b, :R] = counts
                log_freqs_pad[b, :P] = calc_path_log_frequencies(path_counts)
            pending.append(
                (
                    chunk,
                    _diploid_pair_scores_batched(
                        *shard_batched(
                            jnp.asarray(probs_pad),
                            jnp.asarray(noise_pad),
                            jnp.asarray(counts_pad),
                            jnp.asarray(log_freqs_pad),
                        )
                    ),
                )
            )
    return pending


def gather_pair_scores(pending, cluster_inputs):
    """Block on :func:`dispatch_pair_scores` chunks; returns
    [(cluster index, (P, P) float64 score matrix)]."""
    out = []
    for chunk, pair_ll_dev in pending:
        pair_ll = np.asarray(pair_ll_dev, dtype=np.float64)
        for b, idx in enumerate(chunk):
            P = cluster_inputs[idx][0].shape[1]
            out.append((idx, pair_ll[b, :P, :P]))
    return out


def _native_diploid_select(score_matrices, min_rel_likelihood: float):
    """Batched selection + normalisation over precomputed (P, P) pair
    score matrices through the native kernel; None without the
    library.  Identical to _diploid_select per matrix."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from ..native import load_library

    lib = load_library()
    n = len(score_matrices)
    if n == 0:
        return []
    n_cols = np.fromiter((m.shape[0] for m in score_matrices), np.int64, n)
    score_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=score_offsets[1:])
    tri_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * (n_cols + 1) // 2, out=tri_offsets[1:])
    scores_concat = np.concatenate(
        [np.ascontiguousarray(m, dtype=np.float64).ravel() for m in score_matrices]
    )
    out_nkeep = np.zeros(n, dtype=np.int64)
    out_pairs = np.empty(2 * int(tri_offsets[-1]), dtype=np.int32)
    out_post = np.empty(int(tri_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_select_ragged(
        as_f64(scores_concat), as_i64(score_offsets), as_i64(tri_offsets),
        as_i64(n_cols), n, float(min_rel_likelihood),
        int(min(16, os.cpu_count() or 1)), as_i64(out_nkeep),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), as_f64(out_post),
    )

    results = []
    for b in range(n):
        kept = int(out_nkeep[b])
        base = int(tri_offsets[b])
        pairs = out_pairs[2 * base : 2 * (base + kept)].reshape(kept, 2)
        results.append((pairs.tolist(), out_post[base : base + kept]))
    return results


def path_group_posteriors_diploid(
    probs: np.ndarray,
    noise: np.ndarray,
    counts: np.ndarray,
    path_counts: Sequence[int],
    min_rel_likelihood: float,
) -> Tuple[List[List[int]], np.ndarray]:
    """Diploid posterior with the reference's relative-likelihood cutoff:
    pairs below max * min_rel_likelihood carry zero posterior and are
    dropped from the reported group sets."""
    log_freqs = calc_path_log_frequencies(path_counts)
    groups, log_liks = _diploid_log_likelihoods(probs, noise, counts, log_freqs)

    max_ll = log_liks.max()
    keep = log_liks - max_ll >= math.log(min_rel_likelihood)
    kept_groups = [g for g, k in zip(groups, keep) if k]
    posteriors = _normalize_log_posteriors(log_liks[keep])
    return kept_groups, posteriors


def gibbs_iteration_counts(group_size: int, num_paths: int) -> Tuple[int, int, int]:
    """Chain/burn-in/sample sizing scaled to problem size (reference
    path_estimator.cpp:4-11,501-503)."""
    scale = group_size * num_paths
    chains = MIN_GIBBS_CHAINS + round(GIBBS_CHAIN_SCALING * scale)
    burn = MIN_BURN_ITS + round(BURN_ITS_SCALING * scale)
    its = MIN_GIBBS_ITS + round(GIBBS_ITS_SCALING * scale)
    return chains, burn, its


def _gibbs_chains_core(key, probs, noise, counts, log_freqs, group_size, num_chains,
                       num_its, num_real_paths):
    """Run all chains in parallel; returns (chains, its, group_size)
    sampled path indices per recorded iteration (burn-in included —
    caller slices).  num_real_paths may be traced (only the randint
    init bound depends on it, so traced and static produce identical
    draws)."""
    P = num_real_paths

    def conditional_logits(occupied_sum, slot_col):
        # occupied_sum: (R,) sum of other slots' cols / g; candidate col
        # added per path: logits over P paths.
        group = noise[:, None] + occupied_sum[:, None] + probs / group_size
        logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
        return backend.fixed_order_sum(counts[:, None] * logs, 0) + log_freqs

    def chain_step(state, key):
        group = state  # (group_size,) int32 path indices
        keys = jax.random.split(key, group_size)

        def slot_body(j, group):
            mask = jnp.arange(group_size) != j
            occupied = (
                backend.fixed_order_sum(probs[:, group] * mask[None, :], 1) / group_size
            )
            logits = conditional_logits(occupied, j)
            new_path = jax.random.categorical(keys[j], logits)
            return group.at[j].set(new_path.astype(group.dtype))

        group = jax.lax.fori_loop(0, group_size, slot_body, group)
        return group, group

    def run_chain(key):
        init_key, scan_key = jax.random.split(key)
        init_group = jax.random.randint(init_key, (group_size,), 0, P, dtype=jnp.int32)
        step_keys = jax.random.split(scan_key, num_its)
        _, samples = jax.lax.scan(chain_step, init_group, step_keys)
        return samples  # (num_its, group_size)

    chain_keys = jax.random.split(key, num_chains)
    return jax.vmap(run_chain)(chain_keys)


@partial(jax.jit, static_argnames=("group_size", "num_chains", "num_its", "num_real_paths"))
def _gibbs_chains(key, probs, noise, counts, log_freqs, group_size, num_chains, num_its,
                  num_real_paths=None):
    P = num_real_paths if num_real_paths is not None else probs.shape[1]
    return _gibbs_chains_core(
        key, probs, noise, counts, log_freqs, group_size, num_chains, num_its, P
    )


@partial(jax.jit, static_argnames=("group_size", "num_chains", "num_its"))
def _gibbs_chains_vmapped(keys, probs, noise, counts, log_freqs, p_real, group_size,
                          num_chains, num_its):
    """Batch axis over clusters: keys (B, 2), probs (B, R, P), noise
    (B, R), counts (B, R), log_freqs (B, P), p_real (B,)."""
    return jax.vmap(
        _gibbs_chains_core, in_axes=(0, 0, 0, 0, 0, None, None, None, 0)
    )(keys, probs, noise, counts, log_freqs, group_size, num_chains, num_its, p_real)


def _posterior_gibbs_native(cluster_inputs, rng_keys):
    """CPU speed path for diploid posterior Gibbs: pair-score matrices
    are the cached conditionals (the +lf[other] row constant cancels in
    the categorical), so chains sample cached rows in C++.  Returns None
    when the native library is unavailable."""
    import ctypes
    import os

    matrices = _native_pair_scores(cluster_inputs)
    if matrices is None:
        return None
    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    sizing = [
        gibbs_iteration_counts(2, item[0].shape[1]) for item in cluster_inputs
    ]
    n_cols = np.array([item[0].shape[1] for item in cluster_inputs], dtype=np.int64)
    chains = np.array([s[0] for s in sizing], dtype=np.int64)
    burn = np.array([s[1] for s in sizing], dtype=np.int64)
    its = np.array([s[2] for s in sizing], dtype=np.int64)
    score_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=score_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(chains * its * 2, out=out_offsets[1:])
    seeds = np.array(
        [
            (np.uint64(np.asarray(key).astype(np.uint64)[0]) << np.uint64(32))
            | np.uint64(np.asarray(key).astype(np.uint64)[1])
            for key in rng_keys
        ],
        dtype=np.uint64,
    )
    scores_concat = np.concatenate([m.ravel() for m in matrices])
    out = np.empty(int(out_offsets[-1]), dtype=np.int32)

    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_posterior_gibbs_ragged(
        scores_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        as_i64(score_offsets), as_i64(n_cols), as_i64(chains), as_i64(burn),
        as_i64(its), seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        as_i64(out_offsets), n, int(min(16, os.cpu_count() or 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )

    # Normalise + dedup the sampled diplotypes natively (the twin of
    # np.sort(axis=1) + np.unique(axis=0, return_counts=True), which
    # dominated this configuration's host time).
    if not getattr(lib, "_pair_dedup_configured", False):
        lib.rpvg_pair_dedup_ragged.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_pair_dedup_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._pair_dedup_configured = True
    import struct as _struct

    dd_len = ctypes.c_int64()
    dd_ptr = lib.rpvg_pair_dedup_ragged(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_i64(out_offsets), n, int(min(16, os.cpu_count() or 1)),
        ctypes.byref(dd_len),
    )
    try:
        data = ctypes.string_at(dd_ptr, dd_len.value)
    finally:
        lib.rpvg_buffer_free(dd_ptr)
    (n_out,) = _struct.unpack_from("<q", data, 0)
    assert n_out == n
    n_unique = np.frombuffer(data, dtype=np.int64, count=n, offset=8)
    offset = 8 + 8 * n
    (uniq_total,) = _struct.unpack_from("<q", data, offset)
    offset += 8
    pairs_all = np.frombuffer(
        data, dtype=np.int32, count=2 * uniq_total, offset=offset
    ).reshape(-1, 2)
    offset += 8 * uniq_total
    counts_all = np.frombuffer(data, dtype=np.int64, count=uniq_total, offset=offset)
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_unique, out=bounds[1:])

    results = []
    for i in range(n):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        groups = pairs_all[lo:hi].tolist()
        results.append((groups, counts_all[lo:hi] / float(chains[i] * its[i])))
    return results


def path_group_posteriors_gibbs_batched(cluster_inputs, group_size, rng_keys):
    """Collapsed-Gibbs posteriors over many clusters with shape
    bucketing: one jit program per (R, P) bucket, with chain count and
    iteration count padded to the bucket maximum and sliced per cluster
    — the threefry key-split is counter-based, so the sliced prefix is
    bitwise identical to each cluster's exact-size run (and to
    :func:`path_group_posteriors_gibbs` with the same key).

    cluster_inputs: per cluster (probs (R, P), noise (R,), counts (R,),
    path_counts).  Returns per cluster (groups, posteriors)."""
    if group_size == 2 and not backend.device_enabled():
        native = _posterior_gibbs_native(cluster_inputs, rng_keys)
        if native is not None:
            backend.count_work("posterior_gibbs", False, len(cluster_inputs))
            return native
    backend.count_work("posterior_gibbs", True, len(cluster_inputs))

    buckets = {}
    for idx, item in enumerate(cluster_inputs):
        R, P = item[0].shape
        buckets.setdefault((_ceil_pow2(R), _ceil_pow2(P)), []).append(idx)

    results = [None] * len(cluster_inputs)
    for (R_pad, P_pad), indices in buckets.items():
        sizing = []
        for idx in indices:
            P = cluster_inputs[idx][0].shape[1]
            chains, burn, its = gibbs_iteration_counts(group_size, P)
            sizing.append((chains, burn, its))
        C_max = max(s[0] for s in sizing)
        T_max = max(s[1] + s[2] for s in sizing)

        B = _ceil_pow2(len(indices), floor=1)
        probs = np.zeros((B, R_pad, P_pad), dtype=np.float64)
        noise = np.ones((B, R_pad), dtype=np.float64)
        counts = np.zeros((B, R_pad), dtype=np.float64)
        log_freqs = np.full((B, P_pad), -np.inf)
        log_freqs[:, 0] = 0.0  # dummy clusters sample path 0 harmlessly
        p_real = np.ones(B, dtype=np.int32)
        keys = np.zeros((B,) + np.asarray(rng_keys[indices[0]]).shape, dtype=np.uint32)
        for bi, idx in enumerate(indices):
            p, n, c, path_counts = cluster_inputs[idx]
            R, P = p.shape
            probs[bi, :R, :P] = p
            noise[bi, :R] = n
            counts[bi, :R] = c
            log_freqs[bi, :] = -np.inf
            log_freqs[bi, :P] = calc_path_log_frequencies(path_counts)
            p_real[bi] = P
            keys[bi] = np.asarray(rng_keys[idx])

        from ..parallel.autoshard import shard_batched

        samples = np.asarray(
            _gibbs_chains_vmapped(
                *shard_batched(
                    jnp.asarray(keys),
                    jnp.asarray(probs),
                    jnp.asarray(noise),
                    jnp.asarray(counts),
                    jnp.asarray(log_freqs),
                    jnp.asarray(p_real),
                ),
                group_size,
                C_max,
                T_max,
            )
        )
        for bi, (idx, (chains, burn, its)) in enumerate(zip(indices, sizing)):
            kept = samples[bi, :chains, burn : burn + its, :]
            kept = np.sort(kept, axis=2).reshape(-1, group_size)
            unique, sample_counts = np.unique(kept, axis=0, return_counts=True)
            groups = [list(map(int, row)) for row in unique]
            results[idx] = (groups, sample_counts / float(chains * its))
    return results


def path_group_posteriors_gibbs(
    probs: np.ndarray,
    noise: np.ndarray,
    counts: np.ndarray,
    path_counts: Sequence[int],
    group_size: int,
    rng_key,
) -> Tuple[List[List[int]], np.ndarray]:
    """Collapsed Gibbs over group slots; posterior = sample frequency of
    each sorted group multiset.

    Diploid clusters on CPU route through the native sampler (the same
    per-job stream the batched sweep uses, so per-cluster and batched
    calls agree)."""
    if group_size == 2 and not backend.device_enabled():
        native = _posterior_gibbs_native(
            [(probs, noise, counts, path_counts)], [np.asarray(rng_key)]
        )
        if native is not None:
            return native[0]

    R, P = probs.shape
    log_freqs = calc_path_log_frequencies(path_counts)
    num_chains, num_burn, num_its = gibbs_iteration_counts(group_size, P)

    # Pad to shared shapes (padded rows: unit noise, zero counts; padded
    # paths: -inf prior so they are never sampled).
    R_pad, P_pad = _ceil_pow2(R), _ceil_pow2(P)
    probs_pad = np.zeros((R_pad, P_pad), dtype=np.float64)
    probs_pad[:R, :P] = probs
    noise_pad = np.ones(R_pad, dtype=np.float64)
    noise_pad[:R] = noise
    counts_pad = np.zeros(R_pad, dtype=np.float64)
    counts_pad[:R] = counts
    log_freqs_pad = np.full(P_pad, -np.inf)
    log_freqs_pad[:P] = log_freqs

    samples = _gibbs_chains(
        rng_key,
        jnp.asarray(probs_pad),
        jnp.asarray(noise_pad),
        jnp.asarray(counts_pad),
        jnp.asarray(log_freqs_pad),
        group_size,
        num_chains,
        num_burn + num_its,
        P,
    )
    samples = np.asarray(samples)[:, num_burn:, :]  # (chains, its, g)
    samples = np.sort(samples, axis=2).reshape(-1, group_size)

    unique, sample_counts = np.unique(samples, axis=0, return_counts=True)
    groups = [list(map(int, row)) for row in unique]
    posteriors = sample_counts / float(num_chains * num_its)
    return groups, posteriors


# ---------------------------------------------- batched full enumeration


@jax.jit
def _group_scores_chunk(probs, noise, counts, idx):
    """(B, G) log-likelihoods of the multiset groups in `idx` (G, k):
    score[b, g] = sum_r counts[b, r] * log(noise[b, r] +
    mean_k probs[b, r, idx[g, k]]) — the reference's exhaustive
    enumeration loop (src/path_posterior_estimator.cpp) as one dense
    contraction per bucket."""
    k = idx.shape[1]
    acc = probs[:, :, idx[:, 0]]
    for i in range(1, k):
        acc = acc + probs[:, :, idx[:, i]]
    group = noise[:, :, None] + acc / k
    logs = jnp.where(group > 0, jnp.log(group), -jnp.inf)
    return backend.fixed_order_sum(counts[:, :, None] * logs, 1)


def _log_permutations_rows(groups: np.ndarray) -> np.ndarray:
    """log permutation prior per row of sorted index tuples — the
    reference's n! / (n - u + 1)! with u unique values (src/utils.hpp:
    95-117, mirrored by mathutils.num_permutations), NOT the multinomial
    coefficient.  Exact integer arithmetic so the float matches
    math.log(num_permutations(group))."""
    G, k = groups.shape
    if k == 1:
        return np.zeros(G, dtype=np.float64)
    uniques = 1 + (groups[:, 1:] != groups[:, :-1]).sum(axis=1)
    denom = np.array(
        [math.factorial(k - u + 1) for u in range(1, k + 1)], dtype=np.int64
    )
    return np.log(math.factorial(k) // denom[uniques - 1])


# Enumeration explodes combinatorially with ploidy; buckets whose padded
# group count exceeds this fall back to the per-cluster host engine.
_FULL_ENUM_GROUP_LIMIT = 1 << 17


def full_posteriors_batched(cluster_inputs, group_size: int):
    """Exhaustive group-posterior enumeration over many clusters at once
    (`haplotypes` with non-diploid ploidy and no Gibbs): clusters bucket
    into padded power-of-two shapes, every bucket's multiset enumeration
    is scored by one dense device kernel (G-chunked to bound memory),
    and the group-prior terms + normalization run on the host in float64
    — the same math as :func:`path_group_posteriors_full` per cluster.

    cluster_inputs: per cluster (probs (R, P), noise (R,), counts (R,),
    path_counts).  Returns per cluster (groups, posteriors)."""
    from ..parallel.autoshard import shard_batched

    dtype = backend.device_dtype()

    results = [None] * len(cluster_inputs)
    buckets = {}
    for ci, (probs, _, _, _) in enumerate(cluster_inputs):
        R, P = probs.shape
        P_pad = _ceil_pow2(P)
        if math.comb(P_pad + group_size - 1, group_size) > _FULL_ENUM_GROUP_LIMIT:
            p_, n_, c_, pc = cluster_inputs[ci]
            results[ci] = path_group_posteriors_full(p_, n_, c_, pc, group_size)
            continue
        buckets.setdefault((_ceil_pow4(R), P_pad), []).append(ci)

    pending = []  # (chunk indices, [(g0, device scores)], groups_pad)
    for (R_pad, P_pad), indices in buckets.items():
        groups_pad = np.asarray(
            list(combinations_with_replacement(range(P_pad), group_size)),
            dtype=np.int32,
        )
        G_pad = len(groups_pad)
        max_batch = max(1, 4096 // R_pad) * 8
        for chunk_start in range(0, len(indices), max_batch):
            chunk = indices[chunk_start : chunk_start + max_batch]
            B = _ceil_pow2(len(chunk), floor=1)

            probs_pad = np.zeros((B, R_pad, P_pad), dtype=dtype)
            noise_pad = np.ones((B, R_pad), dtype=dtype)
            counts_pad = np.zeros((B, R_pad), dtype=dtype)
            for b, ci in enumerate(chunk):
                probs, noise, counts, _ = cluster_inputs[ci]
                R, P = probs.shape
                probs_pad[b, :R, :P] = probs
                noise_pad[b, :R] = noise
                counts_pad[b, :R] = counts

            probs_dev, noise_dev, counts_dev = shard_batched(
                jnp.asarray(probs_pad), jnp.asarray(noise_pad), jnp.asarray(counts_pad)
            )
            # Chunk the group axis so the (B, R, G) intermediate stays
            # bounded; every chunk pads to the fixed width so the kernel
            # compiles once per bucket.
            g_chunk = _ceil_pow2(max(1, (1 << 24) // max(1, B * R_pad)), floor=128)
            parts = []
            for g0 in range(0, G_pad, g_chunk):
                idx_block = np.zeros((g_chunk, group_size), dtype=np.int32)
                block = groups_pad[g0 : g0 + g_chunk]
                idx_block[: len(block)] = block
                parts.append(
                    (
                        g0,
                        len(block),
                        _group_scores_chunk(
                            probs_dev, noise_dev, counts_dev, jnp.asarray(idx_block)
                        ),
                    )
                )
            pending.append((chunk, parts, groups_pad))

    for chunk, parts, groups_pad in pending:
        G_pad = len(groups_pad)
        scores = np.empty((len(parts[0][2]), G_pad), dtype=np.float64)
        for g0, width, dev in parts:
            scores[:, g0 : g0 + width] = np.asarray(dev, dtype=np.float64)[:, :width]
        for b, ci in enumerate(chunk):
            probs, _, _, path_counts = cluster_inputs[ci]
            P = probs.shape[1]
            valid = (groups_pad < P).all(axis=1)
            groups_real = groups_pad[valid]
            log_freqs = calc_path_log_frequencies(path_counts)
            ll = (
                scores[b, valid]
                + log_freqs[groups_real].sum(axis=1)
                + _log_permutations_rows(groups_real)
            )
            results[ci] = (
                [list(map(int, row)) for row in groups_real],
                _normalize_log_posteriors(ll),
            )
    return results
