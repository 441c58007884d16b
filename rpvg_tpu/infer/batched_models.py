"""Whole-population batched execution of the inference models.

The per-cluster estimators are the specification; these drivers execute
the same computation across ALL clusters at once so device kernels are
dispatched O(buckets) times instead of O(clusters) — the TPU analogue of
the reference's `omp parallel for` over size-sorted clusters
(src/main.cpp:829).

Covered here:
* `transcripts` (incl. read-count Gibbs): one batched EM sweep, then
  one batched Gibbs sweep.
* `haplotypes` (diploid, non-Gibbs): one batched dense pair-scoring
  sweep over all clusters.
* `haplotype-transcripts` (collapsed, diploid, incl. read-count Gibbs):
  batched grouped pair scoring -> host subset selection -> one batched
  EM run over every (cluster, subset) task -> batched Gibbs jobs.
* `strains` (incl. read-count Gibbs): host greedy cover per cluster ->
  one batched EM run over every cover sub-matrix -> batched Gibbs.

Batched read-count and posterior Gibbs are bitwise identical to the
per-cluster dispatch (counter-based threefry: padded draws share their
prefix; key chains replicated with a vmapped scan).  Non-diploid
non-Gibbs full enumeration runs through one dense device kernel per
bucket (posteriors.full_posteriors_batched), so every model + flag
combination executes whole-population batched; the per-cluster
estimators remain as the tested specification.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import backend
from ..constants import HAPLOTYPES_MIN_REL_LIKELIHOOD
from .batching import em_postprocess, run_batched_em
from .estimators import (
    MinimumPathAbundanceEstimator,
    NestedPathAbundanceEstimator,
    PathAbundanceEstimator,
    PathGroupPosteriorEstimator,
)
from .matrices import construct_probability_matrix, total_read_count
from .posteriors import diploid_posteriors_batched

# Flattened [len, ids...] specs for the memoised (shared) group lists
# returned by find_path_source_groups, keyed by object identity — the
# memo holds the lists alive, so ids stay valid; the identity check
# guards against id reuse for non-memoised lists.
_FLAT_SPEC_CACHE: Dict[int, Tuple[list, tuple]] = {}


def _flat_group_spec(groups: List[List[int]]) -> Tuple[np.ndarray, int]:
    """(flat int64 spec, n_cols) for native_subset_collapse_multi."""
    key = id(groups)
    hit = _FLAT_SPEC_CACHE.get(key)
    if hit is not None and hit[0] is groups:
        return hit[1]
    stream: List[int] = []
    for col in groups:
        stream.append(len(col))
        stream.extend(col)
    spec = (np.asarray(stream, dtype=np.int64), len(groups))
    if len(_FLAT_SPEC_CACHE) < 1_000_000:
        _FLAT_SPEC_CACHE[key] = (groups, spec)
    return spec


def supports_batched_haplotypes(estimator) -> bool:
    # Every configuration: Gibbs sampling, the diploid dense engine, and
    # non-diploid full enumeration all have whole-population drivers.
    return isinstance(estimator, PathGroupPosteriorEstimator)


def batched_haplotypes(estimator, cluster_data, rng_seed: int = 0, ranks=None) -> None:
    """cluster_data: list of (PathClusterEstimates with .paths set,
    cluster_probs).  Mutates estimates in place.  `ranks` maps the
    cluster_data index to its global cluster rank (identity when None) —
    the rank seeds the per-cluster RNG, so a multi-host strided subset
    reproduces the single-host draws."""
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    from .posteriors import path_group_posteriors_gibbs_batched

    inputs = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(est.paths))
        inputs.append((probs, noise, counts, [p.source_count for p in est.paths]))
        meta.append(ci)

    if estimator.use_hap_gibbs:
        keys = cluster_gibbs_keys(rng_seed, [rank_of(ci) for ci in meta])
        results = path_group_posteriors_gibbs_batched(inputs, estimator.ploidy, keys)
    elif estimator.ploidy == 2:
        results = diploid_posteriors_batched(inputs, HAPLOTYPES_MIN_REL_LIKELIHOOD)
    else:
        from .posteriors import full_posteriors_batched

        results = full_posteriors_batched(inputs, estimator.ploidy)
    for ci, (groups, posteriors) in zip(meta, results):
        est = cluster_data[ci][0]
        est.path_group_sets = groups
        est.posteriors = list(map(float, posteriors))


def supports_batched_nested(estimator, num_gibbs_samples: int) -> bool:
    # Gibbs, diploid dense scoring, and non-diploid full enumeration all
    # have whole-population drivers.
    return isinstance(estimator, NestedPathAbundanceEstimator)


def _group_posteriors_batched(inputs, group_size: int, min_rel_likelihood: float):
    """Non-Gibbs group posteriors for many clusters: dense diploid
    scoring at group size 2, exhaustive enumeration otherwise — the
    batched twin of PathPosteriorEstimator._group_posteriors."""
    if group_size == 2:
        return diploid_posteriors_batched(inputs, min_rel_likelihood)
    from .posteriors import full_posteriors_batched

    return full_posteriors_batched(inputs, group_size)


def batched_haplotype_transcripts_independent(estimator, cluster_data, rng_seed: int = 0, ranks=None) -> None:
    """Batched independent-group nested inference (--ind-hap-inference):
    every (cluster, transcript-group) posterior job runs through the
    batched diploid / collapsed-Gibbs engines, subset sampling replays
    each cluster's host RNG stream, then the shared EM+Gibbs tail runs.
    Bitwise identical to the per-cluster estimator."""
    import math
    import os
    import sys
    import time

    from .posteriors import path_group_posteriors_gibbs_batched

    from .matrices import cluster_matrix, native_subset_collapse_multi

    timing = bool(os.environ.get("RPVG_TPU_PHASE_TIMING"))
    t0 = time.perf_counter()
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    jobs = []  # (ci, gi, group)
    cluster_groups: Dict[int, List[List[int]]] = {}
    dense_clusters = []
    slot_of_ci: Dict[int, int] = {}
    group_jobs = []
    group_counts_of = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        path_groups = estimator.find_path_groups(est.paths)
        cluster_groups[ci] = path_groups
        slot_of_ci[ci] = len(dense_clusters)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        for gi, group in enumerate(path_groups):
            flat = np.empty(2 * len(group), dtype=np.int64)
            flat[0::2] = 1
            flat[1::2] = group
            group_jobs.append((slot_of_ci[ci], (flat, len(group))))
            group_counts_of.append([est.paths[i].source_count for i in group])
            jobs.append((ci, gi, group))

    # One threaded native call builds every (cluster, transcript-group)
    # matrix (the per-job Python loop was the config's hotspot).
    multi = native_subset_collapse_multi(
        dense_clusters, group_jobs, estimator.prob_precision
    )
    if multi is not None:
        inputs = [
            (full[:, :-1], full[:, -1], counts, gc)
            for (full, counts), gc in zip(multi, group_counts_of)
        ]
    else:
        inputs = [
            estimator._subset_matrix(
                cluster_data[ci][1], group, len(cluster_data[ci][0].paths)
            ) + (gc,)
            for (ci, _, group), gc in zip(jobs, group_counts_of)
        ]

    if timing:
        print(f"  [timing]   I group matrices ({len(jobs)} jobs): {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    if estimator.use_group_post_gibbs:
        cis = sorted(cluster_groups)
        depth = max((len(cluster_groups[ci]) for ci in cis), default=0)
        chains = (
            cluster_gibbs_key_chains(rng_seed, [rank_of(ci) for ci in cis], depth)
            if cis
            else []
        )
        chain_of = {ci: chains[i] for i, ci in enumerate(cis)}
        keys = [chain_of[ci][gi] for ci, gi, _ in jobs]
        results = path_group_posteriors_gibbs_batched(
            inputs, estimator.group_size, keys
        )
    else:
        results = _group_posteriors_batched(
            inputs, estimator.group_size, estimator.min_hap_prob
        )

    if timing:
        print(f"  [timing]   I group posteriors: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    per_cluster_jobs: Dict[int, List] = {}
    for (ci, gi, group), res in zip(jobs, results):
        per_cluster_jobs.setdefault(ci, []).append((group, res))

    num_samples = math.floor(1.0 / estimator.min_hap_prob)
    cluster_tasks: Dict[int, List[dict]] = {}
    all_tasks: List[Tuple[int, dict]] = []
    key_base_of: Dict[int, int] = {}
    np_rng_of: Dict[int, np.random.Generator] = {}
    inc = 1.0 / num_samples
    # repeated_sums[k] = inc added k times to 0.0 (np.cumsum performs
    # the same sequential float64 additions the per-sample loop does, so
    # looking the total up is bitwise identical to adding in a loop).
    repeated_sums = np.empty(num_samples + 1, dtype=np.float64)
    repeated_sums[0] = 0.0
    np.cumsum(np.full(num_samples, inc), out=repeated_sums[1:])
    for ci in cluster_groups:
        est, cluster_probs = cluster_data[ci]
        np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
        # Distinct transcript-group choices repeat across the ~1/p
        # samples, and disjoint groups make the choice tuple determine
        # the subset — so dedup the choice matrix first and expand only
        # unique rows (first-seen order; per-key mass accumulated by the
        # same repeated additions the per-sample loop performs).
        jobs_ci = per_cluster_jobs.get(ci, [])
        choice_cols = []
        decode_cache: List[Dict[int, List[int]]] = []
        # One uniform block per cluster replaces the per-job
        # Generator.choice calls: choice(n, size, p) draws
        # self.random(size) and searchsorts the normalised CDF, so a
        # (jobs, samples) block consumed row-major is the identical
        # stream and the searchsorted picks are bitwise identical
        # (verified against numpy 2.x; per-call validation overhead
        # dominated this loop).
        if jobs_ci:
            uniform_block = np_rng.random((len(jobs_ci), num_samples))
        for j, (group, (groups_g, posteriors)) in enumerate(jobs_ci):
            if len(groups_g) == 1:
                # Single candidate: every sample picks group-set 0 (the
                # job's uniform row was still drawn, keeping the stream
                # aligned with the per-cluster estimator's choice call).
                choice_cols.append(None)
                decode_cache.append({})
                continue
            p = np.asarray(posteriors, dtype=np.float64)
            # Generator.choice's input validation, kept explicitly: a
            # degenerate posterior must fail loudly, not mis-sample
            # (an all-zero vector would make the CDF NaN and searchsorted
            # return an out-of-range choice).
            if not np.isfinite(p).all() or (p < 0).any() or p.sum() <= 0:
                raise ValueError(
                    "group posteriors contain NaN/inf, negative entries, "
                    "or sum to zero"
                )
            p = p / p.sum()
            cdf = p.cumsum()
            cdf /= cdf[-1]
            choice_cols.append(cdf.searchsorted(uniform_block[j], side="right"))
            decode_cache.append({})

        def mapped(j: int, choice: int) -> List[int]:
            # Decode a chosen group-set lazily (only chosen indices are
            # ever needed; eager decoding of every candidate group-set
            # dominated this loop).
            cache = decode_cache[j]
            hit = cache.get(choice)
            if hit is None:
                group, (groups_g, _) = jobs_ci[j]
                hit = [group[l] for l in sorted(groups_g[choice])]
                cache[choice] = hit
            return hit

        subset_probs: Dict[tuple, float] = {}
        if choice_cols:
            # Pack each sample's per-group choices into one integer and
            # dedup with a 1-D unique; first-seen order (and the
            # per-key repeated additions) replicate the per-sample loop.
            sizes = [len(groups_g) for _, (groups_g, _) in jobs_ci]
            space = 1
            for s in sizes:
                space *= s
            if space == 1:
                # Every job has one candidate group-set: all samples
                # pick the same subset (packed would be all zeros).
                rows = [(0, num_samples)]
                decode = True
            elif space <= 2**62:
                packed = np.zeros(num_samples, dtype=np.int64)
                stride = 1
                for col, s in zip(choice_cols, sizes):
                    if col is not None:  # None = all-zero column (s == 1)
                        packed += col.astype(np.int64) * stride
                    stride *= s
                uniq, first_idx, counts = np.unique(
                    packed, return_index=True, return_counts=True
                )
                rows = [
                    (int(uniq[u]), int(counts[u]))
                    for u in np.argsort(first_idx, kind="stable")
                ]
                decode = True
            else:  # pragma: no cover - pathological group counts
                from collections import Counter

                rows = list(
                    Counter(
                        zip(
                            *(
                                c.tolist() if c is not None else [0] * num_samples
                                for c in choice_cols
                            )
                        )
                    ).items()
                )
                decode = False
            for packed_key, cnt in rows:
                subset: List[int] = []
                if decode:
                    rem = packed_key
                    for j, s in enumerate(sizes):
                        subset.extend(mapped(j, rem % s))
                        rem //= s
                else:
                    for j, choice in enumerate(packed_key):
                        subset.extend(mapped(j, choice))
                key = tuple(sorted(subset))
                prev = subset_probs.get(key)
                if prev is None:
                    # inc added cnt times from 0.0, via the lookup table.
                    subset_probs[key] = float(repeated_sums[cnt])
                else:
                    # Resumed accumulation (two choice tuples mapping to
                    # the same sorted subset) must keep the loop's exact
                    # addition order.
                    for _ in range(cnt):
                        prev += inc
                    subset_probs[key] = prev
        else:
            subset_probs[()] = float(repeated_sums[num_samples])

        est.total_count = total_read_count(cluster_probs)
        tasks = estimator.prepare_subset_specs(subset_probs)
        cluster_tasks[ci] = tasks
        all_tasks.extend((ci, task) for task in tasks)
        key_base_of[ci] = (
            len(per_cluster_jobs.get(ci, [])) if estimator.use_group_post_gibbs else 0
        )
        np_rng_of[ci] = np_rng

    if timing:
        print(f"  [timing]   I subset sampling: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    # Fill every task matrix in one threaded native call (per-cluster
    # Python fallback without the library).
    fill_jobs = []
    for ci, task in all_tasks:
        collapsed = task["collapsed"]
        flat = np.empty(2 * len(collapsed), dtype=np.int64)
        flat[0::2] = 1
        flat[1::2] = collapsed
        fill_jobs.append((slot_of_ci[ci], (flat, len(collapsed))))
    multi_fill = native_subset_collapse_multi(
        dense_clusters, fill_jobs, estimator.prob_precision
    )
    if multi_fill is not None:
        for (_, task), (sub_full, sub_counts) in zip(all_tasks, multi_fill):
            task["matrix"] = sub_full
            task["counts"] = sub_counts
    else:
        for ci, tasks in cluster_tasks.items():
            if tasks:
                estimator.fill_subset_matrices(
                    cluster_data[ci][1], len(cluster_data[ci][0].paths), tasks
                )

    if timing:
        print(f"  [timing]   I task fill ({len(all_tasks)} tasks): {time.perf_counter() - t0:.2f}s", file=sys.stderr)

    _nested_em_and_gibbs(
        estimator, cluster_data, cluster_tasks, all_tasks, rng_seed,
        key_base_of, np_rng_of=np_rng_of, rank_of=rank_of,
    )


def cluster_gibbs_key_chains(rng_seed: int, ranks: Sequence[int], depth: int) -> np.ndarray:
    """keys[i, j] = the (j+1)-th `ClusterRNG.next_key()` of cluster
    ranks[i] (the split-chain replicated with a vmapped scan, bitwise
    identical to sequential splitting)."""
    import jax
    import jax.numpy as jnp

    base = jax.random.PRNGKey(rng_seed)
    folded = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.asarray(list(ranks)))

    def chain(key):
        def step(carry, _):
            new_carry, sub = jax.random.split(carry)
            return new_carry, sub

        _, subs = jax.lax.scan(step, key, None, length=depth)
        return subs

    return np.asarray(jax.vmap(chain)(folded))


def batched_haplotype_transcripts(estimator, cluster_data, rng_seed: int = 0, ranks=None) -> None:
    """Batched collapsed-group nested inference; mutates the estimates
    in cluster_data in place."""
    import os
    import sys
    import time

    timing = bool(os.environ.get("RPVG_TPU_PHASE_TIMING"))
    t0 = time.perf_counter()

    # Cleared here; the fused path re-stashes its columnar set streams
    # for the native output composer when every slot combined natively.
    estimator._columnar_outputs = None

    # Fused native path for the diploid non-Gibbs configuration: the
    # whole grouped-matrix -> posterior -> subset-selection -> collapse
    # -> EM chain runs in one threaded C++ call (bitwise identical to
    # the staged kernels below).  Gibbs configurations and group sizes
    # other than 2 keep the staged path.
    if (
        estimator.group_size == 2
        and not estimator.use_group_post_gibbs
        and os.environ.get("RPVG_TPU_FUSED_NESTED", "1") != "0"
    ):
        from .batching import native_em_available

        if native_em_available():
            done = _batched_haplotype_transcripts_fused(
                estimator, cluster_data, timing, t0, rng_seed, ranks
            )
            if done:
                return

    # Phase A (host): grouped probability matrices — one threaded native
    # call across every cluster (per-cluster Python fallback without the
    # library).
    from .matrices import cluster_matrix, native_subset_collapse_multi

    meta: List[Tuple[int, List[List[int]]]] = []
    dense_clusters = []
    group_jobs = []
    source_counts_of = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        source_groups, source_counts = estimator.find_path_source_groups(est.paths)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        group_jobs.append((len(dense_clusters) - 1, _flat_group_spec(source_groups)))
        source_counts_of.append(source_counts)
        meta.append((ci, source_groups))

    multi = native_subset_collapse_multi(
        dense_clusters, group_jobs, estimator.prob_precision
    )
    inputs = []
    if multi is not None:
        for (full, counts), source_counts in zip(multi, source_counts_of):
            inputs.append((full[:, :-1], full[:, -1], counts, source_counts))
    else:
        for (ci, source_groups), source_counts in zip(meta, source_counts_of):
            g_probs, g_noise, g_counts = estimator._group_posterior_matrix(
                cluster_data[ci][1], source_groups, len(cluster_data[ci][0].paths)
            )
            inputs.append((g_probs, g_noise, g_counts, source_counts))

    if timing:
        print(f"  [timing]   A grouped matrices: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    # Phase B (device): group posteriors for every cluster — dense
    # diploid scoring, or the batched collapsed-Gibbs sampler when
    # --use-hap-gibbs (consuming each cluster's FIRST PRNG key, exactly
    # as the per-cluster estimator does).
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    if estimator.use_group_post_gibbs:
        from .posteriors import path_group_posteriors_gibbs_batched

        posterior_results = path_group_posteriors_gibbs_batched(
            inputs,
            estimator.group_size,
            cluster_gibbs_keys(rng_seed, [rank_of(ci) for ci, _ in meta]),
        )
    else:
        posterior_results = _group_posteriors_batched(
            inputs, estimator.group_size, estimator.min_hap_prob
        )

    if timing:
        print(f"  [timing]   B diploid posteriors: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    # Phase C (host): subset selection, then EM task matrices for every
    # (cluster, subset) in one threaded native call.
    all_tasks: List[Tuple[int, dict]] = []
    cluster_tasks: Dict[int, List[dict]] = {}
    subset_jobs = []
    min_hap_prob = estimator.min_hap_prob
    for slot, ((ci, source_groups), (groups, posteriors)) in enumerate(
        zip(meta, posterior_results)
    ):
        est, cluster_probs = cluster_data[ci]

        subset_probs: Dict[tuple, float] = {}
        total_posterior = 0.0
        for group_set, posterior in zip(groups, posteriors):
            if posterior >= min_hap_prob:
                path_subset: List[int] = []
                for g in group_set:
                    path_subset.extend(source_groups[g])
                key = tuple(sorted(path_subset))
                subset_probs[key] = subset_probs.get(key, 0.0) + float(posterior)
                total_posterior += float(posterior)

        est.total_count = total_read_count(cluster_probs)
        tasks = []
        for key, posterior in subset_probs.items():
            subset_prob = posterior / total_posterior
            if subset_prob < min_hap_prob:
                continue
            collapsed: List[int] = []
            multiplicity: Dict[int, int] = {}
            for pid in key:
                if not collapsed or pid != collapsed[-1]:
                    collapsed.append(pid)
                    multiplicity[pid] = 1
                else:
                    multiplicity[pid] += 1
            task = {
                "subset": key,
                "subset_prob": subset_prob,
                "collapsed": collapsed,
                "multiplicity": multiplicity,
            }
            tasks.append(task)
            flat = np.empty(2 * len(collapsed), dtype=np.int64)
            flat[0::2] = 1
            flat[1::2] = collapsed
            subset_jobs.append((slot, (flat, len(collapsed))))
        cluster_tasks[ci] = tasks
        all_tasks.extend((ci, task) for task in tasks)

    multi = native_subset_collapse_multi(
        dense_clusters, subset_jobs, estimator.prob_precision
    )
    if multi is not None:
        for (_, task), (sub_full, sub_counts) in zip(all_tasks, multi):
            task["matrix"] = sub_full
            task["counts"] = sub_counts
    else:
        for ci, tasks in cluster_tasks.items():
            if tasks:
                estimator.fill_subset_matrices(
                    cluster_data[ci][1], len(cluster_data[ci][0].paths), tasks
                )

    if timing:
        print(f"  [timing]   C subset selection: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    _nested_em_and_gibbs(
        estimator,
        cluster_data,
        cluster_tasks,
        all_tasks,
        rng_seed,
        {ci: (1 if estimator.use_group_post_gibbs else 0) for ci in cluster_tasks},
        timing,
        t0,
        rank_of=rank_of,
    )


def _batched_haplotype_transcripts_fused(
    estimator, cluster_data, timing, t0, rng_seed=0, ranks=None
) -> bool:
    """Native execution of the collapsed diploid nested model
    (native rpvg_nested_diploid_infer), including read-count Gibbs
    configurations (task matrices are emitted for the sampler); returns
    False when the native library is unavailable so the staged path
    runs.

    On accelerator backends the measured link policy
    (parallel.linkprobe.select_device_slots) routes the largest clusters
    to the device: a first emit-only native pass produces their subset
    task matrices, their EM dispatches asynchronously, and the full
    native pass over the remaining clusters runs WHILE the device round
    trip is in flight — host and device compute concurrently, so the
    device share is pure wall-clock saving."""
    import os
    import sys
    import time

    from ..native import nested_diploid_infer
    from .matrices import cluster_matrix

    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__

    meta: List[int] = []
    dense_clusters = []
    group_specs = []
    group_src_counts = []
    group_ids = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        source_groups, source_counts = estimator.find_path_source_groups(est.paths)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        group_specs.append(_flat_group_spec(source_groups))
        group_src_counts.append(source_counts)
        group_ids.append(
            np.fromiter(
                (info.group_id for info in est.paths), np.int64, len(est.paths)
            )
        )
        meta.append(ci)

    # Legacy within-call task-level deferral (explicit env overrides
    # only; the measured slot-level routing below is the default).
    em_area_cutoff = 0
    device_pos: List[int] = []
    env_hybrid = os.environ.get("RPVG_TPU_HYBRID_EM_AREA")
    if backend.device_enabled() and env_hybrid is not None:
        em_area_cutoff = int(env_hybrid)
        if em_area_cutoff <= 0:
            return False  # hybrid disabled: run everything on device
    elif os.environ.get("RPVG_TPU_FORCE_HYBRID_EM_AREA"):
        # Test hook: exercise the device-deferred path on any backend.
        em_area_cutoff = int(os.environ["RPVG_TPU_FORCE_HYBRID_EM_AREA"])
    elif os.environ.get("RPVG_TPU_DEVICE_SLOT_AREA"):
        # Opt-in whole-slot routing (mainly a test hook; the bounded-EM
        # escalation below is the production hybrid policy).
        from ..parallel.linkprobe import select_device_slots

        areas = [p.shape[0] * p.shape[1] for p, _, _ in dense_clusters]
        device_pos = select_device_slots(areas)

    # Bounded-EM escalation (the measured hybrid policy): the native
    # kernel gives each subset EM a bounded iteration budget; the few
    # tasks that fail to converge inside it — the heavy tail holding
    # ~half the EM time in a few hundred KB of matrices — defer to the
    # device, which re-runs them with identical convergence semantics.
    # Only tasks PROVEN slow leave the native pass.
    # Bounded escalation defaults ON (every backend).  On the CPU the
    # escalated heavy tail re-runs REBATCHED across worker threads —
    # one slot's heavy tasks no longer serialise on a single kernel
    # thread, so the output stays byte-identical to the uninterrupted
    # native run.  On an accelerator it goes to the device.
    em_bound = 0
    if not device_pos and em_area_cutoff == 0:
        em_bound = int(os.environ.get("RPVG_TPU_EM_BOUND", "1024"))

    emit_matrices = estimator.num_gibbs_samples > 0

    def native_call(positions, cutoff, bound=0):
        return nested_diploid_infer(
            [dense_clusters[i] for i in positions],
            [group_specs[i] for i in positions],
            [group_src_counts[i] for i in positions],
            [group_ids[i] for i in positions],
            min_rel_likelihood=estimator.min_hap_prob,
            min_hap_prob=estimator.min_hap_prob,
            prob_precision=estimator.prob_precision,
            max_em_its=estimator.max_em_its,
            max_rel_em_conv=estimator.max_rel_em_conv,
            em_area_cutoff=cutoff,
            em_bound_its=bound,
            emit_matrices=emit_matrices,
        )

    sections = []  # (section meta, streams, pending EM or None)
    if device_pos:
        from .batching import dispatch_em_device

        dev_set = set(device_pos)
        host_pos = [i for i in range(len(meta)) if i not in dev_set]
        # Pass 1 (emit-only): grouped matrices -> posteriors -> subset
        # selection -> collapsed task matrices, no EM (cutoff 1 defers
        # every task).  Then the device EM goes in flight.
        dev_streams = native_call(device_pos, 1)
        if dev_streams is None:
            return False
        dev_inputs = _section_task_matrices(dev_streams, emit_matrices)
        pending = dispatch_em_device(
            dev_inputs, range(len(dev_inputs)),
            estimator.max_em_its, estimator.max_rel_em_conv,
        )
        if timing:
            print(
                f"  [timing]   device pass ({len(device_pos)} slots, "
                f"{len(dev_inputs)} tasks) dispatched: {time.perf_counter() - t0:.2f}s",
                file=sys.stderr,
            )
        # Pass 2: full native inference for the host share, overlapping
        # the device round trip.
        host_streams = native_call(host_pos, 0)
        if host_streams is None:
            return False
        sections.append(([meta[i] for i in host_pos], host_streams, None))
        sections.append(
            ([meta[i] for i in device_pos], dev_streams,
             (pending, dev_inputs, list(range(len(dev_inputs)))))
        )
        stage_floor = 0
    elif (
        em_bound > 0
        and len(meta) > 64
        and os.environ.get("RPVG_TPU_EM_SPLIT", "0") == "1"
    ):
        # Bounded escalation with OVERLAP: the native pass splits into
        # the big-slot quarter (rank order = largest first, so it holds
        # most of the heavy EM tail) and the rest — the first half's
        # escalated tasks fly to the device WHILE the second half runs
        # natively, hiding the link round trip under host compute.
        from .batching import dispatch_em_device

        cut = max(1, len(meta) // 4)
        for positions in (list(range(cut)), list(range(cut, len(meta)))):
            streams_h = native_call(positions, 0, em_bound)
            if streams_h is None:
                return False
            deferred = np.flatnonzero(streams_h["has_fracs"] == 0)
            pend = None
            if deferred.size:
                inputs = _section_task_matrices(
                    streams_h, emit_matrices, task_ids=deferred
                )
                if backend.device_enabled():
                    pend = (
                        dispatch_em_device(
                            inputs, range(len(inputs)),
                            estimator.max_em_its, estimator.max_rel_em_conv,
                            stage_floor=em_bound,
                        ),
                        inputs,
                        deferred.tolist(),
                    )
            sections.append(([meta[i] for i in positions], streams_h, pend))
        stage_floor = em_bound
    else:
        streams = native_call(range(len(meta)), em_area_cutoff, em_bound)
        if streams is None:
            return False
        sections.append((meta, streams, None))
        stage_floor = em_bound

    if timing:
        print(f"  [timing]   fused nested infer: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    col_parts = []
    for sec_meta, sec_streams, sec_pending in sections:
        col_parts.append(
            _process_nested_section(
                estimator, cluster_data, sec_streams, sec_meta, rank_of,
                rng_seed, emit_matrices, sec_pending, timing, t0,
                stage_floor=stage_floor,
            )
        )
        if timing:
            t0 = time.perf_counter()

    _merge_nested_columnar(estimator, col_parts)
    return True


def _native_combine_slots(
    cluster_data, meta, noncomb, task_bounds, col_bounds,
    sp_arr, n_col_arr, collapsed_all, mult_all, totals, task_em_result,
):
    """Batch the deferred slots' posterior-weighted combine through the
    native rpvg_nested_combine kernel.  Returns its stream tuple, or
    None when the library is unavailable (Python fallback runs)."""
    from ..native import nested_combine

    sel_tasks = np.concatenate(
        [np.arange(task_bounds[s], task_bounds[s + 1]) for s in noncomb]
    ).astype(np.int64)
    n_tasks_sub = np.asarray(
        [task_bounds[s + 1] - task_bounds[s] for s in noncomb], dtype=np.int64
    )
    sub_ncol = n_col_arr[sel_tasks]
    sub_col_offsets = np.zeros(sel_tasks.size + 1, dtype=np.int64)
    np.cumsum(sub_ncol, out=sub_col_offsets[1:])
    em_counts_stream = np.empty(int(sub_col_offsets[-1]), dtype=np.float64)
    em_noise_arr = np.empty(sel_tasks.size, dtype=np.float64)
    for k, t in enumerate(sel_tasks):
        path_counts, noise_count = task_em_result(int(t))
        em_counts_stream[sub_col_offsets[k] : sub_col_offsets[k + 1]] = path_counts
        em_noise_arr[k] = noise_count
    cat_cols = lambda src: (  # noqa: E731
        np.concatenate([src[col_bounds[t] : col_bounds[t + 1]] for t in sel_tasks])
        if sel_tasks.size else np.empty(0, dtype=src.dtype)
    )
    gid_arrays = [
        np.fromiter(
            (info.group_id for info in cluster_data[meta[s]][0].paths),
            np.int64,
            len(cluster_data[meta[s]][0].paths),
        )
        for s in noncomb
    ]
    return nested_combine(
        gid_arrays,
        totals[noncomb],
        n_tasks_sub,
        sp_arr[sel_tasks],
        sub_ncol,
        cat_cols(collapsed_all),
        cat_cols(mult_all),
        sub_col_offsets,
        em_counts_stream,
        em_noise_arr,
    )


def _task_matrix_bounds(streams, emit_matrices):
    """CSR bounds into the emitted mats/cnts streams — the Python
    mirror of the kernel's '!run_em || emit_matrices' emission rule
    (one definition, shared by every consumer)."""
    n_col_arr = streams["n_col"]
    kept_arr = streams["kept"]
    has_fracs = streams["has_fracs"].astype(bool)
    T = n_col_arr.size
    has_mat = np.ones(T, dtype=bool) if emit_matrices else ~has_fracs
    mat_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_mat, kept_arr * (n_col_arr + 1), 0), out=mat_bounds[1:])
    cnt_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_mat, kept_arr, 0), out=cnt_bounds[1:])
    return mat_bounds, cnt_bounds


def _section_task_matrices(streams, emit_matrices, task_ids=None):
    """Per-task (matrix, counts) views over a section's emitted
    streams.  `task_ids` selects a subset (default: every task that has
    an emitted matrix — all of them for emit-only sections)."""
    mat_bounds, cnt_bounds = _task_matrix_bounds(streams, emit_matrices)
    kept_arr = streams["kept"]
    n_col_arr = streams["n_col"]
    mats_all = streams["mats"]
    cnts_all = streams["cnts"]
    if task_ids is None:
        task_ids = range(n_col_arr.size)
    return [
        (
            mats_all[mat_bounds[t] : mat_bounds[t + 1]].reshape(
                int(kept_arr[t]), int(n_col_arr[t]) + 1
            ),
            cnts_all[cnt_bounds[t] : cnt_bounds[t + 1]],
        )
        for t in task_ids
    ]


def _process_nested_section(
    estimator, cluster_data, streams, meta, rank_of, rng_seed,
    emit_matrices, pre_dispatched, timing, t0, stage_floor=0,
):
    """Decode one native-call section: device EM for deferred tasks
    (pre-dispatched handles are gathered here), read-count Gibbs, and
    the per-cluster posterior-weighted combine.  Returns the section's
    columnar-output arrays for _merge_nested_columnar."""
    import os
    import sys
    import time

    totals = streams["totals"]
    n_tasks = streams["n_tasks"]
    sp_arr = streams["subset_prob"]
    n_col_arr = streams["n_col"]
    kept_arr = streams["kept"]
    has_fracs = streams["has_fracs"].astype(bool)
    collapsed_all = streams["collapsed"]
    mult_all = streams["mult"]
    fracs_all = streams["fracs"]
    mats_all = streams["mats"]
    cnts_all = streams["cnts"]

    T = sp_arr.size
    task_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_tasks, out=task_bounds[1:])
    col_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(n_col_arr, out=col_bounds[1:])
    fr_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_fracs, n_col_arr + 1, 0), out=fr_bounds[1:])
    mat_bounds, cnt_bounds = _task_matrix_bounds(streams, emit_matrices)

    def task_matrix(t):
        return (
            mats_all[mat_bounds[t] : mat_bounds[t + 1]].reshape(
                int(kept_arr[t]), int(n_col_arr[t]) + 1
            ),
            cnts_all[cnt_bounds[t] : cnt_bounds[t + 1]],
        )

    # Device EM for the deferred tasks.  Pre-dispatched sections (slot
    # routing) gather their in-flight results here; legacy within-call
    # deferral dispatches now.
    if pre_dispatched is not None:
        from .batching import gather_em_device

        pending, dev_inputs, task_ids = pre_dispatched
        device_results = [None] * len(dev_inputs)
        gather_em_device(pending, dev_inputs, device_results)
        device_of = dict(zip(task_ids, device_results))
    else:
        device_tasks = np.flatnonzero(~has_fracs)
        backend.count_work("em", False, int(has_fracs.sum()))
        if device_tasks.size:
            task_inputs = [task_matrix(t) for t in device_tasks]
            # Without a device, escalated sets re-run on the host —
            # REBATCHED across worker threads, which already beats the
            # in-slot execution (one slot's heavy tasks all sit on one
            # thread there).
            if stage_floor > 0 and not backend.device_enabled():
                from .batching import run_native_em

                # Resume from the bounded run's exit state (emitted by
                # the kernel): bitwise-identical to an uninterrupted
                # run, without re-paying the stage_floor iterations.
                resume = None
                remaining_its = estimator.max_em_its
                esc_conv = streams.get("esc_conv")
                if esc_conv is not None and esc_conv.size == device_tasks.size:
                    widths = n_col_arr[device_tasks] + 1
                    esc_fracs = streams["esc_fracs"]
                    if esc_fracs.size == int(widths.sum()):
                        resume = (esc_fracs, esc_conv)
                        remaining_its = max(1, estimator.max_em_its - stage_floor)
                # Without Gibbs the kernel emits mats/cnts for EXACTLY
                # the escalated tasks in order (_task_matrix_bounds:
                # has_mat == ~has_fracs when not emit_matrices) — hand
                # the streams through without re-concatenating
                # ~thousands of small views (profiled at ~0.26s per
                # bench run).  run_native_em size-asserts the match.
                concat = (mats_all, cnts_all) if not emit_matrices else None
                backend.count_work("em", False, len(task_inputs))
                device_results = run_native_em(
                    task_inputs, remaining_its, estimator.max_rel_em_conv,
                    resume_state=resume, concat=concat,
                )
            else:
                device_results = run_batched_em(
                    task_inputs,
                    estimator.max_em_its,
                    estimator.max_rel_em_conv,
                    stage_floor=stage_floor,
                )
            device_of = dict(zip(device_tasks.tolist(), device_results))
        else:
            device_of = {}

    # Post-EM tail (exact run_batched_em/run_native_em semantics).  The
    # kernel already folded these results into its per-slot combine;
    # Python re-derives them only where needed — Gibbs sampler inputs
    # and the (device-deferred) fallback combine below.
    slot_of_task = np.repeat(np.arange(len(meta)), n_tasks)

    def task_em_result(t):
        if has_fracs[t]:
            # Collapse preserves the (integral) read-count total, so
            # the cluster total is exact for the per-task sum.
            return em_postprocess(
                fracs_all[fr_bounds[t] : fr_bounds[t + 1]],
                float(totals[slot_of_task[t]]),
            )
        return device_of[t]

    # Read-count Gibbs sampling per selected subset (exact staged
    # semantics: the posterior phase consumed no PRNG keys in this
    # non-Gibbs-posterior configuration, so key_base is 0 and the host
    # RNG stream starts fresh per cluster rank).
    if estimator.num_gibbs_samples > 0:
        from .readcount_gibbs import run_batched_gibbs

        jobs = []  # (slot, key_idx, task_id, n_here)
        key_ranks = []
        max_depth = 0
        for slot, ci in enumerate(meta):
            np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
            remaining_gibbs = estimator.num_gibbs_samples
            remaining_prob = 1.0
            key_count = 0
            for t in range(int(task_bounds[slot]), int(task_bounds[slot + 1])):
                if remaining_gibbs > 0:
                    sp = float(sp_arr[t])
                    n_here = int(
                        np_rng.binomial(
                            remaining_gibbs, min(1.0, sp / remaining_prob)
                        )
                    )
                    remaining_gibbs -= n_here
                    remaining_prob -= sp
                    if n_here > 0:
                        jobs.append((slot, key_count, t, n_here))
                        key_count += 1
            if key_count:
                key_ranks.append(ci)
                max_depth = max(max_depth, key_count)

        if jobs:
            chains = cluster_gibbs_key_chains(
                rng_seed, [rank_of(ci) for ci in key_ranks], max_depth
            )
            chain_of = {ci: chains[i] for i, ci in enumerate(key_ranks)}

            inputs = []
            keys = []
            for slot, key_idx, t, _ in jobs:
                matrix, counts = task_matrix(t)
                abundances, noise_count = task_em_result(t)
                inputs.append(
                    (
                        matrix,
                        counts,
                        np.asarray(abundances),
                        noise_count,
                        float(totals[slot]),
                    )
                )
                keys.append(chain_of[meta[slot]][key_idx])
            # Exact per-job draw counts: a shorter sequential stream is
            # the longer one's prefix, so no padded draws are needed.
            for (slot, _, t, n_here), (noise_samples, path_samples) in zip(
                jobs,
                run_batched_gibbs(
                    inputs, keys, [job[3] for job in jobs],
                    estimator.gibbs_thin_its,
                ),
            ):
                _attach_gibbs_samples(
                    cluster_data[meta[slot]][0],
                    collapsed_all[col_bounds[t] : col_bounds[t + 1]].tolist(),
                    noise_samples[:n_here],
                    path_samples[:n_here],
                )

        if timing:
            print(f"  [timing]   fused Gibbs ({len(jobs)} jobs): {time.perf_counter() - t0:.2f}s", file=sys.stderr)
            t0 = time.perf_counter()

    # Per-cluster posterior-weighted combination: the kernel already
    # combined every slot whose EM ran natively — assign its group
    # sets/posteriors/abundances directly; only device-deferred slots
    # run the Python combine below.
    combined = streams["combined"].astype(bool)
    n_sets = streams["n_sets"]
    set_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_sets, out=set_bounds[1:])
    set_lens = streams["set_lens"]
    len_bounds = np.zeros(set_lens.size + 1, dtype=np.int64)
    np.cumsum(set_lens, out=len_bounds[1:])
    set_ids_all = streams["set_ids"]
    set_post_all = streams["set_posteriors"]
    set_ab_all = streams["set_abundances"]

    # Non-combined slots (device-EM'd tasks): replay the kernel's exact
    # combine tail in ONE threaded native call over all of them — the
    # per-slot Python combine only remains as the no-library fallback.
    noncomb = np.flatnonzero(~combined)
    native_combined = None
    if noncomb.size:
        native_combined = _native_combine_slots(
            cluster_data, meta, noncomb, task_bounds, col_bounds,
            sp_arr, n_col_arr, collapsed_all, mult_all, totals,
            task_em_result,
        )
    if native_combined is not None:
        (nc_n_sets, nc_noise, nc_set_lens, nc_set_ids,
         nc_set_post, nc_set_ab) = native_combined
        from .estimates import GroupSetViews

        nc_set_bounds = np.zeros(noncomb.size + 1, dtype=np.int64)
        np.cumsum(nc_n_sets, out=nc_set_bounds[1:])
        nc_len_bounds = np.zeros(nc_set_lens.size + 1, dtype=np.int64)
        np.cumsum(nc_set_lens, out=nc_len_bounds[1:])
        for k, slot in enumerate(noncomb):
            est = cluster_data[meta[slot]][0]
            est.total_count = float(totals[slot])
            lo, hi = int(nc_set_bounds[k]), int(nc_set_bounds[k + 1])
            id_lo, id_hi = int(nc_len_bounds[lo]), int(nc_len_bounds[hi])
            est.path_group_sets = GroupSetViews(nc_set_ids, nc_len_bounds, lo, hi)
            est.posteriors = nc_set_post[lo:hi]
            est.abundances = nc_set_ab[id_lo:id_hi]
            est.noise_count = float(nc_noise[k])

    for slot, ci in enumerate(meta):
        est = cluster_data[ci][0]
        if not combined[slot] and native_combined is not None:
            continue
        total_count = float(totals[slot])
        est.total_count = total_count

        if combined[slot]:
            from .estimates import GroupSetViews

            lo, hi = int(set_bounds[slot]), int(set_bounds[slot + 1])
            id_lo, id_hi = int(len_bounds[lo]), int(len_bounds[hi])
            # Zero-copy views over the kernel's streams (list-equivalent
            # for consumers; the composer reads the streams directly).
            est.path_group_sets = GroupSetViews(set_ids_all, len_bounds, lo, hi)
            est.posteriors = set_post_all[lo:hi]
            est.abundances = set_ab_all[id_lo:id_hi]
            est.noise_count = float(streams["slot_noise"][slot])
            continue

        gid_of = [info.group_id for info in est.paths]
        group_estimates: Dict[tuple, List] = {}
        sum_hap_prob = 0.0

        for t in range(int(task_bounds[slot]), int(task_bounds[slot + 1])):
            path_counts, noise_count = task_em_result(t)

            # combine_subset_tasks semantics (reference
            # inferPathSubsetAbundance :608-750 combine tail), reading
            # collapsed/multiplicity arrays: the expanded sorted subset
            # splits by transcript group in first-seen order, each slot
            # position receiving abundance * prob / multiplicity.
            sp = float(sp_arr[t])
            sum_hap_prob += sp
            est.noise_count += noise_count * sp

            by_group_paths: Dict[int, List[int]] = {}
            by_group_vals: Dict[int, List[float]] = {}
            mult_t = mult_all[col_bounds[t] : col_bounds[t + 1]]
            for j, pid in enumerate(
                collapsed_all[col_bounds[t] : col_bounds[t + 1]].tolist()
            ):
                m = int(mult_t[j])
                g = gid_of[pid]
                contrib = float(path_counts[j]) * sp / m
                paths_list = by_group_paths.get(g)
                if paths_list is None:
                    paths_list = by_group_paths[g] = []
                    by_group_vals[g] = []
                vals_list = by_group_vals[g]
                for _ in range(m):
                    paths_list.append(pid)
                    vals_list.append(contrib)

            for g, group_paths in by_group_paths.items():
                key = tuple(group_paths)
                entry = group_estimates.get(key)
                if entry is None:
                    entry = group_estimates[key] = [0.0, [0.0] * len(group_paths)]
                entry[0] += sp
                vals = by_group_vals[g]
                acc = entry[1]
                for i in range(len(acc)):
                    acc[i] += vals[i]

        est.path_group_sets = []
        est.posteriors = []
        est.abundances = []
        for key, (posterior, path_abundances) in group_estimates.items():
            est.path_group_sets.append(list(key))
            est.posteriors.append(posterior)
            est.abundances.extend(path_abundances)

        est.noise_count += (1.0 - sum_hap_prob) * est.total_count

    if native_combined is not None:
        # Interleave the kernel's set streams (combined slots) with the
        # native-combine streams (deferred slots) in slot order, so the
        # output composer sees every slot natively combined.
        pos_in_nc = {int(s): k for k, s in enumerate(noncomb)}
        lens_segs, post_segs, ids_segs, ab_segs = [], [], [], []
        n_sets_merged = np.empty(len(meta), dtype=np.int64)
        for slot in range(len(meta)):
            if combined[slot]:
                lo, hi = int(set_bounds[slot]), int(set_bounds[slot + 1])
                id_lo, id_hi = int(len_bounds[lo]), int(len_bounds[hi])
                lens_segs.append(set_lens[lo:hi])
                post_segs.append(set_post_all[lo:hi])
                ids_segs.append(set_ids_all[id_lo:id_hi])
                ab_segs.append(set_ab_all[id_lo:id_hi])
                n_sets_merged[slot] = hi - lo
            else:
                k = pos_in_nc[slot]
                lo, hi = int(nc_set_bounds[k]), int(nc_set_bounds[k + 1])
                id_lo, id_hi = int(nc_len_bounds[lo]), int(nc_len_bounds[hi])
                lens_segs.append(nc_set_lens[lo:hi])
                post_segs.append(nc_set_post[lo:hi])
                ids_segs.append(nc_set_ids[id_lo:id_hi])
                ab_segs.append(nc_set_ab[id_lo:id_hi])
                n_sets_merged[slot] = hi - lo
        cat = lambda segs, dt: (  # noqa: E731
            np.concatenate(segs) if segs else np.empty(0, dtype=dt)
        )
        combined = np.ones(len(meta), dtype=bool)
        n_sets = n_sets_merged
        set_lens = cat(lens_segs, np.int64)
        set_ids_all = cat(ids_segs, np.int64)
        set_post_all = cat(post_segs, np.float64)
        set_ab_all = cat(ab_segs, np.float64)

    if timing:
        print(f"  [timing]   fused combine ({T} tasks): {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    return {
        "meta": meta,
        "combined": combined,
        "n_sets": n_sets,
        "set_lens": set_lens,
        "set_ids": set_ids_all,
        "set_posteriors": set_post_all,
        "set_abundances": set_ab_all,
    }


def _merge_nested_columnar(estimator, col_parts) -> None:
    """Stash the columnar set streams so the output phase can compose
    the estimate files in C++ (pipeline._write_hapjoint_columnar)
    without walking the per-cluster Python objects.  Slots that combined
    in Python (device-routed or EM-deferred) have empty stream segments
    — the composer splices their sets from the estimates — so merging
    sections only interleaves the per-slot meta/flags in cluster order;
    set streams concatenate as-is (the non-combined slots contribute
    nothing and the combined slots stay in ascending cluster order)."""
    parts = [p for p in col_parts if p["meta"]]
    if not parts:
        estimator._columnar_outputs = None
        return
    if len(parts) == 1:
        # Single section: cluster ids are unique, so the (ci, pi, slot)
        # tuple sort reduces to one argsort over the meta array.
        meta_arr = np.asarray(parts[0]["meta"], dtype=np.int64)
        perm = np.argsort(meta_arr)
        meta = meta_arr[perm].tolist()
        combined = np.asarray(parts[0]["combined"], dtype=bool)[perm]
        n_sets = np.asarray(parts[0]["n_sets"], dtype=np.int64)[perm]
        set_lens = parts[0]["set_lens"]
        set_ids = parts[0]["set_ids"]
        set_posteriors = parts[0]["set_posteriors"]
        set_abundances = parts[0]["set_abundances"]
    else:
        order = sorted(
            (
                (ci, pi, slot)
                for pi, p in enumerate(parts)
                for slot, ci in enumerate(p["meta"])
            ),
        )
        meta = [ci for ci, _, _ in order]
        combined = np.array(
            [parts[pi]["combined"][slot] for _, pi, slot in order], dtype=bool
        )
        n_sets = np.array(
            [parts[pi]["n_sets"][slot] for _, pi, slot in order], dtype=np.int64
        )
        # Only combined slots own stream segments; they must land in
        # merged meta order.  Gather each combined slot's segment.
        lens_segs, post_segs, ids_segs, ab_segs = [], [], [], []
        bounds = []
        for p in parts:
            sb = np.zeros(len(p["meta"]) + 1, dtype=np.int64)
            np.cumsum(p["n_sets"], out=sb[1:])
            lb = np.zeros(p["set_lens"].size + 1, dtype=np.int64)
            np.cumsum(p["set_lens"], out=lb[1:])
            bounds.append((sb, lb))
        for _, pi, slot in order:
            p = parts[pi]
            sb, lb = bounds[pi]
            lo, hi = int(sb[slot]), int(sb[slot + 1])
            if lo == hi:
                continue
            lens_segs.append(p["set_lens"][lo:hi])
            post_segs.append(p["set_posteriors"][lo:hi])
            ids_segs.append(p["set_ids"][lb[lo] : lb[hi]])
            ab_segs.append(p["set_abundances"][lb[lo] : lb[hi]])
        cat = lambda segs, dt: (  # noqa: E731
            np.concatenate(segs) if segs else np.empty(0, dtype=dt)
        )
        set_lens = cat(lens_segs, np.int64)
        set_posteriors = cat(post_segs, np.float64)
        set_ids = cat(ids_segs, np.int64)
        set_abundances = cat(ab_segs, np.float64)

    estimator._columnar_outputs = {
        "kind": "sets",
        "meta": meta,
        "combined": combined,
        "n_sets": n_sets,
        "set_lens": set_lens,
        "set_ids": set_ids,
        "set_posteriors": set_posteriors,
        "set_abundances": set_abundances,
    }


def _nested_em_and_gibbs(
    estimator, cluster_data, cluster_tasks, all_tasks, rng_seed, key_base_of,
    timing=False, t0=0.0, np_rng_of=None, rank_of=None,
) -> None:
    """Shared tail of the nested drivers: one batched EM run over every
    (cluster, subset) task, batched read-count Gibbs allocation/sampling
    (PRNG-chain exact: key_base_of[ci] keys were already consumed by the
    posterior phase), and posterior-weighted combination."""
    import sys
    import time

    if rank_of is None:
        rank_of = lambda ci: ci  # noqa: E731

    # Phase D (device): one batched EM run over every subset task.
    em_inputs = [(task["matrix"], task["counts"]) for _, task in all_tasks]
    em_results = run_batched_em(
        em_inputs, estimator.max_em_its, estimator.max_rel_em_conv
    )

    if timing:
        print(f"  [timing]   D batched EM ({len(all_tasks)} tasks): {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()

    per_cluster: Dict[int, List] = {}
    for (ci, _), result in zip(all_tasks, em_results):
        per_cluster.setdefault(ci, []).append(result)

    # Phase D2: read-count Gibbs sampling per selected subset, batched.
    # Sample allocation (host binomial thinning across subsets) and the
    # PRNG key chain replicate the per-cluster estimator exactly, so the
    # drawn samples are bitwise identical at equal dtype.
    if estimator.num_gibbs_samples > 0:
        from .readcount_gibbs import run_batched_gibbs

        jobs = []  # (ci, key_idx_in_cluster, task, abundances, noise_count, n_here)
        key_ranks = []
        max_depth = 0
        for ci, tasks in cluster_tasks.items():
            # Keys the posterior phase already consumed for this cluster.
            key_base = key_base_of[ci]
            results_for_ci = per_cluster.get(ci, [])
            # Continue the cluster's host RNG stream where the
            # posterior phase left it (independent-groups mode draws
            # subset choices from it first).
            if np_rng_of is not None and ci in np_rng_of:
                np_rng = np_rng_of[ci]
            else:
                np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
            remaining_gibbs = estimator.num_gibbs_samples
            remaining_prob = 1.0
            key_count = 0
            for task, (abundances, noise_count) in zip(tasks, results_for_ci):
                if remaining_gibbs > 0:
                    n_here = int(
                        np_rng.binomial(
                            remaining_gibbs,
                            min(1.0, task["subset_prob"] / remaining_prob),
                        )
                    )
                    remaining_gibbs -= n_here
                    remaining_prob -= task["subset_prob"]
                    if n_here > 0:
                        jobs.append(
                            (ci, key_count, task, abundances, noise_count, n_here)
                        )
                        key_count += 1
            if key_count:
                key_ranks.append(ci)
                max_depth = max(max_depth, key_base + key_count)

        if jobs:
            chains = cluster_gibbs_key_chains(
                rng_seed, [rank_of(ci) for ci in key_ranks], max_depth
            )
            chain_of = {ci: chains[i] for i, ci in enumerate(key_ranks)}

            # Chain length is baked into the sampler's key-split shape;
            # pad EVERY job to one power-of-two length and slice — the
            # threefry key-split is counter-based, so a longer chain's
            # prefix is bitwise identical to the exact-length run, and a
            # single length keeps the jit program count at the shape
            # buckets alone (the extra padded draws are cheap next to
            # recompiles).
            def _pow2(n):
                size = 1
                while size < n:
                    size *= 2
                return size

            shared_pad = _pow2(max(job[5] for job in jobs))
            by_n: Dict[int, List[int]] = {shared_pad: list(range(len(jobs)))}
            sample_results = [None] * len(jobs)
            for n_pad, idxs in by_n.items():
                inputs = []
                keys = []
                for j in idxs:
                    ci, key_idx, task, abundances, noise_count, _ = jobs[j]
                    inputs.append(
                        (
                            task["matrix"],
                            task["counts"],
                            np.asarray(abundances),
                            noise_count,
                            float(task["counts"].sum()),
                        )
                    )
                    keys.append(chain_of[ci][key_base_of[ci] + key_idx])
                for j, (noise_samples, path_samples) in zip(
                    idxs,
                    run_batched_gibbs(
                        inputs, keys, n_pad, estimator.gibbs_thin_its
                    ),
                ):
                    n_here = jobs[j][5]
                    sample_results[j] = (
                        noise_samples[:n_here],
                        path_samples[:n_here],
                    )

            for job, (noise_samples, path_samples) in zip(jobs, sample_results):
                ci, _, task, _, _, _ = job
                _attach_gibbs_samples(
                    cluster_data[ci][0], task["collapsed"], noise_samples, path_samples
                )

        if timing:
            print(f"  [timing]   D2 batched Gibbs ({len(jobs)} jobs): {time.perf_counter() - t0:.2f}s", file=sys.stderr)
            t0 = time.perf_counter()

    # Phase E (host): posterior-weighted combination per cluster.
    for ci, tasks in cluster_tasks.items():
        est = cluster_data[ci][0]
        estimator.combine_subset_tasks(est, tasks, per_cluster.get(ci, []))


def cluster_gibbs_keys(rng_seed: int, ranks: Sequence[int]) -> np.ndarray:
    """The JAX PRNG key each cluster's first `rng.next_key()` would
    yield (ClusterRNG parity: fold_in(seed, rank) then split), computed
    for all clusters in two vmapped dispatches."""
    import jax
    import jax.numpy as jnp

    base = jax.random.PRNGKey(rng_seed)
    folded = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.asarray(list(ranks)))
    split = jax.vmap(jax.random.split)(folded)
    return np.asarray(split[:, 1])


def _attach_gibbs_samples(est, path_ids, noise_samples, path_samples) -> None:
    from .estimates import CountSamples

    samples = CountSamples(path_ids=list(path_ids))
    samples.noise_samples = list(map(float, noise_samples))
    samples.abundance_samples = list(map(float, path_samples.reshape(-1)))
    est.gibbs_read_count_samples.append(samples)


def supports_batched_transcripts(estimator) -> bool:
    return type(estimator) is PathAbundanceEstimator


def batched_transcripts(estimator, cluster_data, rng_seed: int = 0, ranks=None) -> None:
    """Batched `transcripts` inference: one bucketed EM sweep over every
    cluster, then (when sampling) one bucketed Gibbs sweep.  Mutates the
    estimates in cluster_data in place."""
    from .matrices import add_noise_and_normalize
    from .readcount_gibbs import run_batched_gibbs

    inputs = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(est.paths))
        full_probs = add_noise_and_normalize(probs, noise)
        est.total_count = float(counts.sum())
        inputs.append((full_probs, counts))
        meta.append(ci)

    em_results = run_batched_em(
        inputs, estimator.max_em_its, estimator.max_rel_em_conv
    )
    for ci, (abundances, noise_count) in zip(meta, em_results):
        est = cluster_data[ci][0]
        est.abundances = list(map(float, abundances))
        est.noise_count = noise_count

    # Per-path abundance streams for the native output composer
    # (singleton group sets after reset(P, 1): one row per path).
    estimator._columnar_outputs = {
        "kind": "perpath",
        "meta": meta,
        "ab": [abundances for abundances, _ in em_results],
    }

    if estimator.num_gibbs_samples > 0:
        rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
        keys = cluster_gibbs_keys(rng_seed, [rank_of(ci) for ci in meta])
        gibbs_inputs = [
            (probs, counts, np.asarray(abundances), noise_count, cluster_data[ci][0].total_count)
            for (probs, counts), (abundances, noise_count), ci in zip(
                inputs, em_results, meta
            )
        ]
        gibbs_results = run_batched_gibbs(
            gibbs_inputs, keys, estimator.num_gibbs_samples, estimator.gibbs_thin_its
        )
        for ci, (noise_samples, path_samples) in zip(meta, gibbs_results):
            est = cluster_data[ci][0]
            _attach_gibbs_samples(
                est, range(len(est.path_group_sets)), noise_samples, path_samples
            )


def supports_batched_strains(estimator, num_gibbs_samples: int) -> bool:
    return isinstance(estimator, MinimumPathAbundanceEstimator)


def _batched_strains_fused(estimator, cluster_data, rng_seed, ranks) -> bool:
    """One-call native execution of the strains host half; returns False
    when the native library is unavailable so the staged path runs."""
    from ..native import strains_infer
    from .matrices import cluster_matrix
    from .readcount_gibbs import run_batched_gibbs

    meta: List[int] = []
    dense_clusters = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        meta.append(ci)

    emit = estimator.num_gibbs_samples > 0
    streams = strains_infer(
        dense_clusters,
        estimator.prob_precision,
        estimator.max_em_its,
        estimator.max_rel_em_conv,
        emit_matrices=emit,
    )
    if streams is None:
        return False

    n_cover = streams["n_cover"]
    cover_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_cover, out=cover_bounds[1:])
    kept = streams["kept"]
    if emit:
        mat_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(kept * (n_cover + 1), out=mat_bounds[1:])
        cnt_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(kept, out=cnt_bounds[1:])

    covered_slots = [s for s in range(len(meta)) if n_cover[s] > 0]
    for slot in covered_slots:
        ci = meta[slot]
        est = cluster_data[ci][0]
        est.total_count = float(streams["totals"][slot])
        est.noise_count = float(streams["noise"][slot])
        lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
        abundances = est.abundances
        for pid, v in zip(
            streams["cover"][lo:hi].tolist(),
            streams["path_counts"][lo:hi].tolist(),
        ):
            abundances[pid] += v

    if emit and covered_slots:
        rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
        keys = cluster_gibbs_keys(
            rng_seed, [rank_of(meta[s]) for s in covered_slots]
        )
        gibbs_inputs = []
        for slot in covered_slots:
            nc = int(n_cover[slot])
            matrix = streams["mats"][mat_bounds[slot] : mat_bounds[slot + 1]].reshape(
                int(kept[slot]), nc + 1
            )
            counts = streams["cnts"][cnt_bounds[slot] : cnt_bounds[slot + 1]]
            lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
            gibbs_inputs.append(
                (
                    matrix,
                    counts,
                    streams["path_counts"][lo:hi],
                    float(streams["noise"][slot]),
                    float(streams["totals"][slot]),
                )
            )
        gibbs_results = run_batched_gibbs(
            gibbs_inputs, keys, estimator.num_gibbs_samples,
            estimator.gibbs_thin_its,
        )
        for slot, (noise_samples, path_samples) in zip(covered_slots, gibbs_results):
            lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
            _attach_gibbs_samples(
                cluster_data[meta[slot]][0],
                streams["cover"][lo:hi].tolist(),
                noise_samples,
                path_samples,
            )

    estimator._columnar_outputs = {
        "kind": "cover",
        "meta": [meta[s] for s in covered_slots],
        "covers": [
            streams["cover"][cover_bounds[s] : cover_bounds[s + 1]]
            for s in covered_slots
        ],
        "ab": [
            streams["path_counts"][cover_bounds[s] : cover_bounds[s + 1]]
            for s in covered_slots
        ],
    }
    return True


def batched_strains(estimator, cluster_data, rng_seed: int = 0, ranks=None) -> None:
    """Batched `strains` inference: the greedy cover stays on the host
    (cheap, data-dependent), the per-cover EM runs in one bucketed
    batched sweep instead of per-cluster dispatches, followed by one
    bucketed Gibbs sweep when sampling.  Mutates the estimates in
    cluster_data in place.  With the native library the whole host half
    (cover weights, greedy cover, sub-matrix collapse, EM) fuses into
    one threaded C++ call."""
    import os

    from .readcount_gibbs import run_batched_gibbs

    if os.environ.get("RPVG_TPU_FUSED_STRAINS", "1") != "0":
        from .batching import native_em_available

        if native_em_available() and _batched_strains_fused(
            estimator, cluster_data, rng_seed, ranks
        ):
            return

    tasks = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        task = estimator.prepare_cover_task(est, cluster_probs)
        if task is None:
            continue
        tasks.append(task)
        meta.append(ci)

    em_results = run_batched_em(
        [(task["matrix"], task["counts"]) for task in tasks],
        estimator.max_em_its,
        estimator.max_rel_em_conv,
    )

    if estimator.num_gibbs_samples > 0:
        rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
        keys = cluster_gibbs_keys(rng_seed, [rank_of(ci) for ci in meta])
        gibbs_inputs = [
            (task["matrix"], task["counts"], np.asarray(abundances), noise_count, task["total"])
            for task, (abundances, noise_count) in zip(tasks, em_results)
        ]
        gibbs_results = run_batched_gibbs(
            gibbs_inputs, keys, estimator.num_gibbs_samples, estimator.gibbs_thin_its
        )
        for ci, task, (noise_samples, path_samples) in zip(meta, tasks, gibbs_results):
            _attach_gibbs_samples(
                cluster_data[ci][0], task["min_cover"], noise_samples, path_samples
            )

    for ci, task, (abundances, noise_count) in zip(meta, tasks, em_results):
        estimator.apply_cover_result(cluster_data[ci][0], task, abundances, noise_count)

    estimator._columnar_outputs = {
        "kind": "cover",
        "meta": meta,
        "covers": [task["min_cover"] for task in tasks],
        "ab": [abundances for abundances, _ in em_results],
    }
