"""Expectation-maximisation abundance estimation as JAX kernels.

The EM fixed point is a dense (R, P+1) matvec pair per iteration — the
data-parallel heart of the quantification models.  Two entry points:

* :func:`em_abundances` — one cluster, exact reference convergence
  semantics (/root/reference/src/path_abundance_estimator.cpp:47-114).
* :func:`em_abundances_batched` — padded cluster batches vmapped over a
  leading batch axis with row/column masks, for bucketed execution
  across a device mesh.

Convergence contract: relative change of every abundance >= 1e-8 must
stay within `max_rel_em_conv` for 10 consecutive iterations.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..constants import MIN_EM_ABUNDANCE, MIN_EM_CONV_ITS


def _ceil_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def em_abundances(
    probs: np.ndarray,
    counts: np.ndarray,
    total_count: float,
    max_em_its: int = 10000,
    max_rel_em_conv: float = 0.001,
) -> Tuple[np.ndarray, float]:
    """Run EM on one cluster matrix (with trailing noise column).

    Returns (per-path read counts with sub-threshold mass zeroed,
    noise read count).  Mirrors the tail handling of the reference
    (:100-113): abundances below 1e-8 fold into the noise count.

    The matrix is zero-padded to power-of-two shapes with a column mask
    so the compiled kernel is shared across clusters (a per-shape
    compile per cluster would dominate the run).  On CPU backends the
    C++ ragged kernel runs instead (the same per-cluster loop the
    batched sweep uses, so per-cluster and batched calls are bitwise
    identical)."""
    if not backend.device_enabled():
        from .batching import native_em_available, run_native_em

        if native_em_available():
            [(path_counts, noise_count)] = run_native_em(
                [(probs, counts)], max_em_its, max_rel_em_conv
            )
            return path_counts, noise_count

    from .batching import pad_em_block

    R, C = probs.shape
    dtype = backend.device_dtype()
    probs_pad, counts_pad, col_mask = pad_em_block(
        [(probs, counts)], [0], _ceil_pow2(R), _ceil_pow2(C), dtype
    )
    fracs, _, _ = _em_solve_batched(
        jnp.asarray(probs_pad),
        jnp.asarray(counts_pad),
        jnp.asarray(col_mask),
        jnp.int32(min(max_em_its, 2**31 - 1)),
        dtype(max_rel_em_conv),
    )
    abundances = np.asarray(fracs, dtype=np.float64)[0, :C]
    from .batching import em_postprocess

    return em_postprocess(abundances, total_count)


# ------------------------------------------------------------------ batched


def _masked_em_step(probs, counts, abundances, total_count, col_mask):
    # q-formulation: new_c = a_c * (sum_r counts_r/rowsum_r * P_rc) /
    # total — two matrix-vector sums and O(R + C) elementwise work.  The
    # sums run in a fixed order, so a cluster's iterates do not depend
    # on the batch it shares (backend.fixed_order_sum).
    a = abundances * col_mask
    row_sums = backend.fixed_order_sum(probs * a[None, :], 1)
    q = jnp.where(row_sums > 0, counts / row_sums, 0.0)
    return a * backend.fixed_order_sum(q[:, None] * probs, 0) / jnp.maximum(
        total_count, 1.0
    )


@jax.jit
def _em_solve_batched(probs, counts, col_masks, max_em_its, max_rel_em_conv):
    """probs: (B, R, C); counts: (B, R); col_masks: (B, C).

    Padded rows must have zero counts; padded columns zero mask.  Runs a
    fixed-shape while loop until every cluster in the batch converged."""
    B, _, C = probs.shape
    totals = backend.fixed_order_sum(counts, 1)
    n_cols = col_masks.sum(axis=1)
    init = jnp.where(col_masks > 0, 1.0 / jnp.maximum(n_cols, 1.0)[:, None], 0.0)

    step = jax.vmap(_masked_em_step, in_axes=(0, 0, 0, 0, 0))

    def cond(state):
        _, _, conv_its, it = state
        return (it < max_em_its) & jnp.any(conv_its < MIN_EM_CONV_ITS)

    def body(state):
        abundances, prev, conv_its, it = state
        # Clusters that already hit the consecutive-iteration target are
        # frozen so batchmates can keep iterating without changing them.
        already_done = conv_its >= MIN_EM_CONV_ITS
        new = step(probs, counts, abundances, totals, col_masks)
        new = jnp.where(already_done[:, None], abundances, new)
        active = (new >= MIN_EM_ABUNDANCE) & (col_masks > 0)
        rel_diff = jnp.where(active, jnp.abs(new - abundances) / jnp.where(active, new, 1.0), 0.0)
        has_converged = jnp.all(rel_diff <= max_rel_em_conv, axis=1)
        conv_its = jnp.where(
            already_done, conv_its, jnp.where(has_converged, conv_its + 1, 0)
        )
        return new, abundances, conv_its, it + 1

    abundances, _, conv_its, iterations = jax.lax.while_loop(
        cond,
        body,
        (init, init, jnp.zeros(B, dtype=jnp.int32), jnp.int32(0)),
    )
    return abundances, conv_its, iterations


def em_abundances_batched(
    probs: np.ndarray,
    counts: np.ndarray,
    col_masks: np.ndarray,
    max_em_its: int = 10000,
    max_rel_em_conv: float = 0.001,
    stage_floor: int = 0,
):
    """Batched EM over padded cluster stacks; returns (B, C) abundance
    fractions (caller applies totals/threshold folding).

    Stragglers: in a synchronous batch every cluster pays the slowest
    cluster's iteration count.  Caps escalate in stages — clusters that
    converged at a lower cap keep their (frozen, identical) result,
    unconverged ones re-run alone at the next cap.  `stage_floor` skips
    stages that cannot converge (bounded-EM escalation: the host already
    PROVED these clusters need more than `stage_floor` iterations, so a
    smaller cap is a wasted device round trip)."""
    from ..parallel.autoshard import shard_batched

    probs = jnp.asarray(probs)
    counts = jnp.asarray(counts, dtype=probs.dtype)
    col_masks = jnp.asarray(col_masks, dtype=probs.dtype)
    probs, counts, col_masks = shard_batched(probs, counts, col_masks)
    conv = probs.dtype.type(max_rel_em_conv)

    stages = [
        cap for cap in (128, 1024) if stage_floor < cap < max_em_its
    ] + [int(max_em_its)]
    abundances, conv_its, its = _em_solve_batched(
        probs, counts, col_masks, jnp.int32(stages[0]), conv
    )
    total_its = int(its)
    for cap in stages[1:]:
        unconverged = np.asarray(conv_its < MIN_EM_CONV_ITS)
        if not unconverged.any():
            break
        idx = np.flatnonzero(unconverged)
        # Pad the straggler batch to a power of two (dummy clusters with
        # empty masks converge immediately) so stage shapes stay cached.
        B_sub = 1
        while B_sub < idx.size:
            B_sub *= 2
        pad_idx = np.concatenate([idx, np.zeros(B_sub - idx.size, dtype=idx.dtype)])
        pad_mask_scale = jnp.asarray(
            np.concatenate(
                [np.ones(idx.size), np.zeros(B_sub - idx.size)]
            ).astype(np.asarray(col_masks).dtype)
        )
        sub_abund, sub_conv, sub_its = _em_solve_batched(
            probs[pad_idx],
            counts[pad_idx],
            col_masks[pad_idx] * pad_mask_scale[:, None],
            jnp.int32(cap),
            conv,
        )
        abundances = abundances.at[idx].set(sub_abund[: idx.size])
        conv_its = conv_its.at[idx].set(sub_conv[: idx.size])
        total_its += int(sub_its)
    return np.asarray(abundances, dtype=np.float64), total_its
