"""Three-way differential test for the collapsed nested model: the
fused native driver (rpvg_nested_diploid_infer), the staged batched
driver, and the per-cluster estimator must produce exactly equal
estimates on randomized multi-cluster populations."""

import os

import numpy as np
import pytest

from rpvg_tpu.infer.batched_models import batched_haplotype_transcripts
from rpvg_tpu.infer.batching import native_em_available
from rpvg_tpu.infer.estimates import PathClusterEstimates
from rpvg_tpu.infer.estimators import ClusterRNG, NestedPathAbundanceEstimator
from rpvg_tpu.probabilities import PathInfo, ReadPathProbs


def _random_population(rng, n_clusters):
    """Clusters with varying transcript/haplotype structure, including
    homozygote-dominant clusters and near-tie posteriors that exercise
    the subset_prob filter and key dedup."""
    clusters = []
    for c in range(n_clusters):
        n_transcripts = int(rng.integers(1, 4))
        n_haps = int(rng.integers(2, 5))
        paths = []
        pid = 0
        for t in range(n_transcripts):
            for h in range(n_haps):
                paths.append(
                    PathInfo(
                        name=f"c{c}_t{t}_h{h}",
                        group_id=t,
                        source_count=1,
                        source_ids=frozenset([h]),
                        length=200,
                        effective_length=float(rng.integers(80, 160)),
                    )
                )
                pid += 1
        n_paths = len(paths)
        rpps = []
        for _ in range(int(rng.integers(3, 12))):
            k = int(rng.integers(1, min(4, n_paths) + 1))
            ids = sorted(rng.choice(n_paths, size=k, replace=False).tolist())
            prob = float(rng.uniform(0.2, 0.99)) / k
            rpp = ReadPathProbs(int(rng.integers(1, 30)), 1e-8)
            rpp.noise_prob = float(rng.uniform(1e-4, 0.05))
            rpp.path_probs = [(prob, ids)]
            rpps.append(rpp)
        clusters.append((paths, rpps))
    # A cluster with no probabilities (reset-only path).
    clusters.append(([PathInfo(name="empty", source_ids=frozenset([0]))], []))
    return clusters


def _run(clusters, estimator, mode):
    data = []
    for paths, rpps in clusters:
        est = PathClusterEstimates()
        est.paths = paths
        data.append((est, rpps))
    if mode == "per-cluster":
        for rank, (est, rpps) in enumerate(data):
            estimator.estimate(est, rpps, ClusterRNG(7, rank))
    else:
        saved = os.environ.get("RPVG_TPU_FUSED_NESTED")
        os.environ["RPVG_TPU_FUSED_NESTED"] = "1" if mode == "fused" else "0"
        try:
            batched_haplotype_transcripts(estimator, data, rng_seed=7)
        finally:
            if saved is None:
                os.environ.pop("RPVG_TPU_FUSED_NESTED", None)
            else:
                os.environ["RPVG_TPU_FUSED_NESTED"] = saved
    return [est for est, _ in data]


@pytest.mark.skipif(not native_em_available(), reason="native library unavailable")
@pytest.mark.parametrize("min_hap_prob", [0.001, 0.2])
def test_fused_matches_staged_and_per_cluster(min_hap_prob):
    rng = np.random.default_rng(13)
    clusters = _random_population(rng, 25)
    estimator = NestedPathAbundanceEstimator(
        group_size=2,
        min_hap_prob=min_hap_prob,
        infer_collapsed=True,
        use_group_post_gibbs=False,
    )

    fused = _run(clusters, estimator, "fused")
    staged = _run(clusters, estimator, "staged")
    single = _run(clusters, estimator, "per-cluster")

    # The staged batched driver and the fused kernel share the exact
    # compiled arithmetic: bitwise equality is the contract.
    for a, b in zip(staged, fused):
        assert a.total_count == b.total_count
        assert a.noise_count == b.noise_count
        assert a.path_group_sets == b.path_group_sets
        np.testing.assert_array_equal(
            np.asarray(a.posteriors), np.asarray(b.posteriors)
        )
        np.testing.assert_array_equal(
            np.asarray(a.abundances), np.asarray(b.abundances)
        )

    # The per-cluster spec scores diplotype pairs on the XLA kernel
    # (different reduction order than the C++ engine), so agreement is
    # to float tolerance, not bitwise.
    for a, b in zip(single, fused):
        assert a.total_count == b.total_count
        assert a.path_group_sets == b.path_group_sets
        np.testing.assert_allclose(a.noise_count, b.noise_count, rtol=1e-9)
        np.testing.assert_allclose(
            np.asarray(a.posteriors), np.asarray(b.posteriors), rtol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(a.abundances), np.asarray(b.abundances),
            rtol=1e-6, atol=1e-9,
        )


@pytest.mark.skipif(not native_em_available(), reason="native library unavailable")
def test_fused_gibbs_matches_staged():
    # Read-count Gibbs configuration: the fused path must replicate the
    # staged driver bitwise — sample allocation (host RNG stream), PRNG
    # key chains and the sampler inputs are all identical.
    rng = np.random.default_rng(29)
    clusters = _random_population(rng, 12)
    estimator = NestedPathAbundanceEstimator(
        group_size=2,
        min_hap_prob=0.001,
        infer_collapsed=True,
        use_group_post_gibbs=False,
        num_gibbs_samples=8,
    )

    fused = _run(clusters, estimator, "fused")
    staged = _run(clusters, estimator, "staged")

    for a, b in zip(staged, fused):
        assert a.noise_count == b.noise_count
        assert a.path_group_sets == b.path_group_sets
        np.testing.assert_array_equal(
            np.asarray(a.abundances), np.asarray(b.abundances)
        )
        assert len(a.gibbs_read_count_samples) == len(b.gibbs_read_count_samples)
        for sa, sb in zip(a.gibbs_read_count_samples, b.gibbs_read_count_samples):
            assert sa.path_ids == sb.path_ids
            assert sa.noise_samples == sb.noise_samples
            assert sa.abundance_samples == sb.abundance_samples


@pytest.mark.skipif(not native_em_available(), reason="native library unavailable")
def test_fused_deferred_tasks_match_full_native(monkeypatch):
    # Force a tiny em_area_cutoff so most tasks defer to run_batched_em
    # (the device hybrid path) and slots combine through the Python
    # fallback: results must equal the all-native fused run exactly
    # (run_batched_em routes to the same native EM kernel on CPU).
    import rpvg_tpu.native as native_mod

    rng = np.random.default_rng(31)
    clusters = _random_population(rng, 15)
    estimator = NestedPathAbundanceEstimator(
        group_size=2, min_hap_prob=0.001, infer_collapsed=True,
        use_group_post_gibbs=False,
    )

    full = _run(clusters, estimator, "fused")

    original = native_mod.nested_diploid_infer

    def tiny_cutoff(*args, **kwargs):
        kwargs["em_area_cutoff"] = 8  # nearly everything defers
        return original(*args, **kwargs)

    monkeypatch.setattr(native_mod, "nested_diploid_infer", tiny_cutoff)
    deferred = _run(clusters, estimator, "fused")

    for a, b in zip(full, deferred):
        assert a.noise_count == b.noise_count
        assert a.path_group_sets == b.path_group_sets
        np.testing.assert_array_equal(
            np.asarray(a.abundances), np.asarray(b.abundances)
        )


def _strains_population(rng, n_clusters):
    from rpvg_tpu.probabilities import PathInfo, ReadPathProbs

    clusters = []
    for c in range(n_clusters):
        n_paths = int(rng.integers(1, 9))
        paths = [
            PathInfo(name=f"s{c}_p{p}", group_id=p, source_count=1,
                     source_ids=frozenset([p]), length=150,
                     effective_length=float(rng.integers(60, 140)))
            for p in range(n_paths)
        ]
        rpps = []
        for _ in range(int(rng.integers(2, 10))):
            k = int(rng.integers(1, n_paths + 1))
            ids = sorted(rng.choice(n_paths, size=k, replace=False).tolist())
            rpp = ReadPathProbs(int(rng.integers(1, 25)), 1e-8)
            rpp.noise_prob = float(rng.uniform(1e-4, 0.05))
            rpp.path_probs = [(float(rng.uniform(0.1, 0.95)) / k, ids)]
            rpps.append(rpp)
        # Occasionally a pure-noise row (noise ~ 1): excluded from cover.
        if rng.random() < 0.3:
            rpp = ReadPathProbs(3, 1e-8)
            rpp.noise_prob = 1.0
            rpp.path_probs = []
            rpps.append(rpp)
        clusters.append((paths, rpps))
    clusters.append(([PathInfo(name="empty")], []))
    return clusters


@pytest.mark.skipif(not native_em_available(), reason="native library unavailable")
@pytest.mark.parametrize("gibbs", [0, 6])
def test_fused_strains_matches_staged(gibbs):
    from rpvg_tpu.infer.batched_models import batched_strains
    from rpvg_tpu.infer.estimators import MinimumPathAbundanceEstimator

    rng = np.random.default_rng(41)
    clusters = _strains_population(rng, 30)
    estimator = MinimumPathAbundanceEstimator(num_gibbs_samples=gibbs)

    def run(mode):
        data = []
        for paths, rpps in clusters:
            est = PathClusterEstimates()
            est.paths = paths
            data.append((est, rpps))
        saved = os.environ.get("RPVG_TPU_FUSED_STRAINS")
        os.environ["RPVG_TPU_FUSED_STRAINS"] = "1" if mode == "fused" else "0"
        try:
            batched_strains(estimator, data, rng_seed=11)
        finally:
            if saved is None:
                os.environ.pop("RPVG_TPU_FUSED_STRAINS", None)
            else:
                os.environ["RPVG_TPU_FUSED_STRAINS"] = saved
        return [est for est, _ in data]

    fused = run("fused")
    staged = run("staged")

    for a, b in zip(staged, fused):
        assert a.total_count == b.total_count
        # The greedy cover replays the spec's strict first-max; weights
        # differ only by libm-vs-numpy log ulps, so identical covers and
        # EM results are expected (tolerances guard pathological ties).
        np.testing.assert_allclose(a.noise_count, b.noise_count, rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(a.abundances), np.asarray(b.abundances),
            rtol=1e-9, atol=1e-12,
        )
        assert len(a.gibbs_read_count_samples) == len(b.gibbs_read_count_samples)
        for sa, sb in zip(a.gibbs_read_count_samples, b.gibbs_read_count_samples):
            assert sa.path_ids == sb.path_ids
