"""Ragged -> padded cluster batching.

Cluster sizes are power-law distributed (the reference sorts clusters by
size for OpenMP load balance, src/main.cpp:811-827); on an accelerator
the equivalent is bucketing cluster matrices into a handful of padded shapes
and vmapping the EM kernel over each bucket, so the whole inference pass
compiles O(#buckets) programs instead of O(#clusters).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import MIN_EM_ABUNDANCE
from .. import backend
from .em import em_abundances_batched


def _ceil_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _ceil_pow4(n: int, floor: int = 8) -> int:
    """Coarser (4x-step) bucketing for the row axis: fewer compiled
    shapes at the cost of more padded compute."""
    size = floor
    while size < n:
        size *= 4
    return size


def em_postprocess(fracs: np.ndarray, total: float) -> Tuple[np.ndarray, float]:
    """The reference's sub-threshold folding (path_abundance_estimator.
    cpp:100-113): abundances below 1e-8 zero out, their mass plus the
    noise fraction becomes the noise count.  The masked sum runs
    SEQUENTIALLY in index order (cumsum), bitwise-matching the C++
    em_postprocess_one the native kernels use."""
    path_counts = fracs[:-1] * total
    low = fracs[:-1] < MIN_EM_ABUNDANCE
    low_counts = path_counts[low]
    noise_count = (
        float(low_counts.cumsum()[-1]) if low_counts.size else 0.0
    ) + float(fracs[-1] * total)
    path_counts = path_counts.copy()
    path_counts[low] = 0.0
    return path_counts, noise_count


def run_native_em(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int,
    max_rel_em_conv: float,
    n_threads: int = 0,
    resume_state=None,
    concat=None,
) -> List[Tuple[np.ndarray, float]]:
    """Ragged batched EM through the C++ kernel (CPU speed path): no
    padding, no shape buckets, per-cluster loops on worker threads —
    bitwise identical to calling the kernel per cluster.  Returns the
    same (path read counts, noise count) contract as run_batched_em.

    `resume_state`: optional (init_fracs list (C_i+... = width per
    cluster), conv_its array) — continues a bounded run from its exit
    state bitwise-identically (escalated tasks skip re-running the
    budget).

    `concat`: optional (probs_flat, counts_flat) when the caller's
    cluster_inputs are already in-order views over contiguous streams
    (the fused kernel's escalated-task emission) — skips the Python
    per-cluster concatenation, which dominates this wrapper's cost."""
    import ctypes
    import os

    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    n_rows = np.array([p.shape[0] for p, _ in cluster_inputs], dtype=np.int64)
    n_cols = np.array([p.shape[1] for p, _ in cluster_inputs], dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])

    if concat is not None:
        probs_concat = np.ascontiguousarray(concat[0], dtype=np.float64).ravel()
        counts_concat = np.ascontiguousarray(concat[1], dtype=np.float64)
        if probs_concat.size != int(mat_offsets[-1]) or counts_concat.size != int(
            row_offsets[-1]
        ):
            raise ValueError(
                "concat streams do not cover cluster_inputs exactly: "
                f"{probs_concat.size}/{int(mat_offsets[-1])} matrix elems, "
                f"{counts_concat.size}/{int(row_offsets[-1])} rows"
            )
    else:
        probs_concat = (
            np.concatenate(
                [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _ in cluster_inputs]
            )
            if n
            else np.empty(0, dtype=np.float64)
        )
        counts_concat = (
            np.concatenate([np.asarray(c, dtype=np.float64) for _, c in cluster_inputs])
            if n
            else np.empty(0, dtype=np.float64)
        )
    out_counts = np.empty(max(0, int(col_offsets[-1]) - n), dtype=np.float64)
    out_noise = np.empty(n, dtype=np.float64)

    if n_threads <= 0:
        from ..native import thread_budget

        n_threads = thread_budget()
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    if not getattr(lib, "_em_counts_configured", False):
        lib.rpvg_em_ragged_counts_resume.restype = None
        lib.rpvg_em_ragged_counts_resume.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib._em_counts_configured = True
    init_fracs_ptr = ctypes.POINTER(ctypes.c_double)()
    init_conv_ptr = ctypes.POINTER(ctypes.c_int64)()
    if resume_state is not None:
        init_fracs, init_conv = resume_state
        init_fracs = np.ascontiguousarray(init_fracs, dtype=np.float64)
        init_conv = np.ascontiguousarray(init_conv, dtype=np.int64)
        assert init_fracs.size == int(col_offsets[-1])
        assert init_conv.size == n
        init_fracs_ptr = as_f64(init_fracs)
        init_conv_ptr = as_i64(init_conv)
    lib.rpvg_em_ragged_counts_resume(
        as_f64(probs_concat), as_f64(counts_concat),
        as_i64(mat_offsets), as_i64(row_offsets), as_i64(col_offsets),
        as_i64(n_rows), as_i64(n_cols), n,
        int(max_em_its), float(max_rel_em_conv), int(n_threads),
        init_fracs_ptr, init_conv_ptr,
        as_f64(out_counts), as_f64(out_noise),
    )

    results: List[Tuple[np.ndarray, float]] = []
    for i in range(n):
        path_counts = out_counts[col_offsets[i] - i : col_offsets[i + 1] - (i + 1)]
        results.append((path_counts, float(out_noise[i])))
    return results


def native_em_available() -> bool:
    import os

    if os.environ.get("RPVG_TPU_NATIVE_EM", "1") == "0":
        return False
    try:
        from ..native import load_library

        return load_library() is not None
    except Exception:
        return False


def hybrid_host_indices(matrices) -> List[int]:
    """Indices of the cluster matrices that run on the native host
    kernels although the device path is on.

    The cluster population is power-law sized, so most matrices are
    tiny and their EM or Gibbs sweep is bound by per-dispatch latency,
    while the few big buckets carry the FLOPs: matrices with fewer than
    RPVG_TPU_HYBRID_EM_AREA elements stay on the host.  The cutoff is
    not yet measured on the H100; 0 sends everything to the device."""
    import os

    if not backend.device_enabled() or not native_em_available():
        return []
    area_cutoff = int(os.environ.get("RPVG_TPU_HYBRID_EM_AREA", 262144))
    if area_cutoff <= 0:
        return []
    return [
        idx
        for idx, probs in enumerate(matrices)
        if probs.shape[0] * probs.shape[1] < area_cutoff
    ]


def run_batched_em(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int = 10000,
    max_rel_em_conv: float = 0.001,
    dtype=None,
    max_bucket_rows: int = 4096,
    stage_floor: int = 0,
) -> List[Tuple[np.ndarray, float]]:
    """Run EM over many clusters with shape bucketing.

    cluster_inputs: per cluster (noise-normalised probs (R, P+1), counts
    (R,)).  Returns per cluster (path read counts, noise count) with the
    reference's sub-threshold folding.  On an accelerator the XLA
    while-loop kernel runs over padded buckets in the device dtype
    (backend.device_dtype); on the CPU the C++ ragged kernel runs in
    float64.  Small clusters stay on the host (hybrid_host_indices)."""
    on_device = backend.device_enabled()
    if dtype is None:
        dtype = backend.device_dtype()
    # CPU speed path: the C++ ragged kernel (threads, no padding) —
    # identical convergence contract; RPVG_TPU_NATIVE_EM=0 disables.
    if not on_device and dtype == np.float64 and native_em_available():
        backend.count_work("em", False, len(cluster_inputs))
        return run_native_em(cluster_inputs, max_em_its, max_rel_em_conv)
    # Escalated tasks (stage_floor > 0) are PROVEN to need more than
    # stage_floor iterations — heavy compute per transferred byte — so
    # they always go to the device; the area-based host routing only
    # applies to cold dispatches of unknown iteration count.
    host_idx: List[int] = []
    if on_device and stage_floor <= 0:
        host_idx = hybrid_host_indices([probs for probs, _ in cluster_inputs])
    host_set = set(host_idx)

    results: List[Tuple[np.ndarray, float]] = [None] * len(cluster_inputs)
    pending = dispatch_em_device(
        cluster_inputs,
        [idx for idx in range(len(cluster_inputs)) if idx not in host_set],
        max_em_its, max_rel_em_conv,
        dtype=dtype, max_bucket_rows=max_bucket_rows, stage_floor=stage_floor,
    )

    # em_abundances_batched syncs on each stage's convergence flags, so
    # the device chunks have finished here: host and device EM do not
    # overlap yet.
    if host_idx:
        backend.count_work("em", False, len(host_idx))
        host_results = run_native_em(
            [cluster_inputs[idx] for idx in host_idx], max_em_its, max_rel_em_conv
        )
        for idx, result in zip(host_idx, host_results):
            results[idx] = result

    gather_em_device(pending, cluster_inputs, results)
    return results


def dispatch_em_device(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    indices: Sequence[int],
    max_em_its: int = 10000,
    max_rel_em_conv: float = 0.001,
    dtype=None,
    max_bucket_rows: int = 4096,
    stage_floor: int = 0,
):
    """Run the indexed clusters' EM on the device: pads shape buckets,
    runs each chunk's staged fixed point, returns a pending handle for
    :func:`gather_em_device`.  Each chunk completes before the next is
    padded (the stage loop reads convergence flags back), so callers
    that do host work between dispatch and gather do not overlap it
    with the device yet."""
    if dtype is None:
        dtype = backend.device_dtype()
    indices = list(indices)
    backend.count_work("em", True, len(indices))
    pending = []  # (chunk indices, (B, C_pad) fractions)
    for chunk, R_pad, C_pad in em_chunk_plan(
        cluster_inputs, indices, max_bucket_rows, stage_floor
    ):
        # Each block is built right before its dispatch, so peak host
        # memory stays at one chunk.
        probs_pad, counts_pad, col_masks = pad_em_block(
            cluster_inputs, chunk, R_pad, C_pad, dtype
        )
        fracs, _ = em_abundances_batched(
            probs_pad, counts_pad, col_masks, max_em_its,
            max_rel_em_conv, stage_floor=stage_floor,
        )
        pending.append((chunk, fracs))
    return pending


def em_chunk_plan(cluster_inputs, indices, max_bucket_rows=4096, stage_floor=0):
    """[(chunk indices, R_pad, C_pad)]: clusters bucketed by padded
    shape (rows to powers of four, columns to powers of two), buckets
    split into chunks of at most max(1, max_bucket_rows // R_pad) * 8
    clusters to bound device memory."""
    indices = list(indices)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    # Small ESCALATED sets are bound by per-chunk dispatch latency:
    # unify the column pad so only the row classes remain — <=4 chunks
    # instead of ~a dozen.  Gated on stage_floor (escalation) — a
    # general dispatch with power-law widths would otherwise pad every
    # cluster to the global max and blow up the padded FLOPs/bytes.
    c_pad_all = 0
    if stage_floor > 0 and 0 < len(indices) <= 512:
        c_pad_all = _ceil_pow2(
            max(cluster_inputs[idx][0].shape[1] for idx in indices)
        )
    for idx in indices:
        R, C = cluster_inputs[idx][0].shape
        key = (_ceil_pow4(R), c_pad_all or _ceil_pow2(C))
        buckets.setdefault(key, []).append(idx)
    plan = []
    for (R_pad, C_pad), members in buckets.items():
        max_batch = max(1, max_bucket_rows // R_pad) * 8
        for start in range(0, len(members), max_batch):
            plan.append((members[start : start + max_batch], R_pad, C_pad))
    return plan


def pad_em_block(cluster_inputs, chunk, R_pad, C_pad, dtype):
    """Zero-padded (B, R_pad, C_pad) probs, (B, R_pad) counts and
    (B, C_pad) column masks for `chunk`.  B is the next power of two,
    so (B, R, C) shapes stay cached; dummy zero-mask clusters converge
    immediately."""
    B = _ceil_pow2(len(chunk), floor=1)
    probs_pad = np.zeros((B, R_pad, C_pad), dtype=dtype)
    counts_pad = np.zeros((B, R_pad), dtype=dtype)
    col_masks = np.zeros((B, C_pad), dtype=dtype)
    for b, idx in enumerate(chunk):
        probs, counts = cluster_inputs[idx]
        R, C = probs.shape
        probs_pad[b, :R, :C] = probs
        counts_pad[b, :R] = counts
        col_masks[b, :C] = 1.0
    return probs_pad, counts_pad, col_masks


def gather_em_device(pending, cluster_inputs, results) -> None:
    """Block on the pending device chunks and fill `results` with the
    (path read counts, noise count) contract (sub-threshold folding in
    f64 on the host, exactly like the native kernel's tail)."""
    for chunk, fracs in pending:
        fracs = np.asarray(fracs, dtype=np.float64)
        for b, idx in enumerate(chunk):
            probs, counts = cluster_inputs[idx]
            R, C = probs.shape
            total = float(counts.sum())
            results[idx] = em_postprocess(fracs[b, :C], total)
