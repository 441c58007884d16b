"""Additional end-to-end coverage: ploidy 3 (full enumeration),
--path-node-cluster, probability-file content verification, independent
nested inference, and sharded multiprocess execution."""

import gzip
import math

import numpy as np
import pytest

from rpvg_tpu import sim
from rpvg_tpu.pipeline import PipelineConfig, run_pipeline


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e_extra")
    panel = sim.build_panel(
        num_transcripts=3, num_haplotypes=3, exons_per_transcript=3,
        exon_length=90, variant_sites=1, seed=41,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 250, read_length=60, frag_mean=150, frag_sd=12, seed=43
    )
    aln_path = str(tmp / "aln.json")
    sim.write_alignment_json(records, aln_path)
    info_path = str(tmp / "info.tsv")
    panel.write_info_tsv(info_path)
    return {"panel": panel, "alignments": aln_path, "info": info_path}


def base_config(dataset, prefix, **kwargs):
    defaults = dict(
        graph=dataset["panel"].graph,
        paths=dataset["panel"].paths_index,
        alignments=dataset["alignments"],
        output_prefix=prefix,
        inference_model="transcripts",
        rng_seed=42,
        score_not_qual=True,
    )
    defaults.update(kwargs)
    return PipelineConfig(**defaults)


def read_tsv(path):
    with open(path) as handle:
        header = handle.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in handle if line.strip()]
    return header, rows


def test_haplotypes_ploidy3_full_enumeration(dataset, tmp_path):
    prefix = str(tmp_path / "p3")
    config = base_config(dataset, prefix, inference_model="haplotypes", ploidy=3)
    run_pipeline(config)
    header, rows = read_tsv(prefix + ".txt")
    assert header == ["Name_1", "Name_2", "Name_3", "ClusterID", "HaplotypingProbability"]
    by_cluster = {}
    for row in rows:
        by_cluster.setdefault(row[3], 0.0)
        by_cluster[row[3]] += float(row[4])
    for total in by_cluster.values():
        assert total == pytest.approx(1.0, abs=1e-4)


def test_haplotype_transcripts_ploidy3(dataset, tmp_path):
    prefix = str(tmp_path / "ht3")
    config = base_config(
        dataset, prefix, inference_model="haplotype-transcripts",
        path_info=dataset["info"], ploidy=3,
    )
    run_pipeline(config)
    header, rows = read_tsv(prefix + ".txt")
    counts = {row[0]: float(row[5]) for row in rows}
    assert sum(counts.values()) == pytest.approx(250, rel=1e-6)


def test_independent_hap_inference(dataset, tmp_path):
    prefix = str(tmp_path / "ind")
    config = base_config(
        dataset, prefix, inference_model="haplotype-transcripts",
        path_info=dataset["info"], ind_hap_inference=True,
    )
    run_pipeline(config)
    header, rows = read_tsv(prefix + ".txt")
    counts = {row[0]: float(row[5]) for row in rows}
    assert sum(counts.values()) == pytest.approx(250, rel=1e-6)


def test_path_node_cluster_flag(dataset, tmp_path):
    prefix = str(tmp_path / "pnc")
    config = base_config(dataset, prefix, path_node_cluster=True)
    stats = run_pipeline(config)
    # Node-sharing clustering merges haplotypes of each transcript.
    assert stats["num_clusters"] <= 3 * 3
    header, rows = read_tsv(prefix + ".txt")
    counts = {row[0]: float(row[4]) for row in rows}
    assert sum(counts.values()) == pytest.approx(250, rel=1e-6)


def test_probs_file_content(dataset, tmp_path):
    prefix = str(tmp_path / "probs")
    config = base_config(dataset, prefix, write_probs=True)
    run_pipeline(config)

    with gzip.open(prefix + "_probs.txt.gz", "rt") as handle:
        lines = handle.read().splitlines()

    assert lines[0] == "#"
    cluster_count = sum(1 for line in lines if line == "#")
    assert cluster_count >= 1

    i = 0
    total_reads = 0
    while i < len(lines):
        assert lines[i] == "#"
        path_specs = lines[i + 1].split(" ")
        n_paths = len(path_specs)
        for spec in path_specs:
            name, length, eff_len = spec.rsplit(",", 2)
            assert float(length) > 0
            assert float(eff_len) > 0
        i += 2
        while i < len(lines) and lines[i] != "#":
            fields = lines[i].split(" ")
            count = int(fields[0])
            noise = float(fields[1])
            total_reads += count
            prob_sum = noise
            for entry in fields[2:]:
                prob, ids = entry.split(":")
                id_list = [int(x) for x in ids.split(",")]
                assert all(0 <= pid < n_paths for pid in id_list)
                prob_sum += float(prob) * len(id_list)
            assert prob_sum == pytest.approx(1.0, abs=1e-3)
            i += 1
    assert total_reads == 250


def test_multiprocess_runner(dataset, tmp_path):
    from rpvg_tpu.parallel.multihost import run_pipeline_multiprocess

    base_prefix = str(tmp_path / "mp_base")
    run_pipeline(base_config(dataset, base_prefix))

    # 1 worker covers the single-shard adopt-directly fast path (no
    # cross-shard merge); 2 covers the native merge kernel.
    for workers in (1, 2):
        prefix = str(tmp_path / f"mp_{workers}")
        run_pipeline_multiprocess(base_config(dataset, prefix), workers)
        with open(base_prefix + ".txt") as a, open(prefix + ".txt") as b:
            assert a.read() == b.read()

    # -t 4 --multiprocess 1: the lone worker gets ALL four threads (the
    # thread budget divides across workers, it is not pinned to 1) and
    # the multithreaded worker scan stays byte-identical.
    import dataclasses

    prefix = str(tmp_path / "mp_1w4t")
    config = dataclasses.replace(base_config(dataset, prefix), threads=4)
    run_pipeline_multiprocess(config, 1)
    with open(base_prefix + ".txt") as a, open(prefix + ".txt") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize(
    "parent_platform, start_method", [(None, "fork"), ("cpu", "fork"), ("gpu", "spawn")]
)
def test_multiprocess_starts_the_platform_after_the_workers(
    dataset, tmp_path, monkeypatch, capsys, parent_platform, start_method
):
    """The workers fork before the parent starts its JAX platform, which
    comes up while they scan; a parent that already drives an
    accelerator spawns them instead.  Outputs are byte-identical."""
    import multiprocessing.pool

    from rpvg_tpu import backend
    from rpvg_tpu.parallel.multihost import run_pipeline_multiprocess

    base_prefix = str(tmp_path / "base")
    run_pipeline(base_config(dataset, base_prefix))

    events = []
    pool_init = multiprocessing.pool.Pool.__init__
    platform = backend.platform

    def recording_pool_init(self, *args, **kwargs):
        events.append("pool")
        pool_init(self, *args, **kwargs)

    monkeypatch.setattr(multiprocessing.pool.Pool, "__init__", recording_pool_init)
    monkeypatch.setattr(backend, "platform", lambda: events.append("platform") or platform())
    monkeypatch.setattr(backend, "initialised_platform", lambda: parent_platform)
    capsys.readouterr()
    prefix = str(tmp_path / "mp")
    run_pipeline_multiprocess(base_config(dataset, prefix), 2)
    assert events[:2] == ["pool", "platform"]
    assert f"2 worker processes ({start_method})" in capsys.readouterr().err
    with open(base_prefix + ".txt") as a, open(prefix + ".txt") as b:
        assert a.read() == b.read()


def test_multiprocess_tmpfs_payload(dataset, tmp_path, monkeypatch):
    """Workers spilling their columnar dumps through /dev/shm (the
    large-payload transfer path, forced here with a 1-byte threshold)
    must be byte-identical to the pipe payloads, for both the
    single-shard adopt and the cross-shard merge, and must leave no
    stray spill files behind."""
    import glob
    import os

    from rpvg_tpu.parallel.multihost import run_pipeline_multiprocess

    if not os.path.isdir("/dev/shm"):
        pytest.skip("no tmpfs")
    base_prefix = str(tmp_path / "shm_base")
    run_pipeline(base_config(dataset, base_prefix))

    monkeypatch.setenv("RPVG_TPU_SHM_PAYLOAD_MIN", "1")
    for workers in (1, 2):
        prefix = str(tmp_path / f"shm_{workers}")
        run_pipeline_multiprocess(base_config(dataset, prefix), workers)
        with open(base_prefix + ".txt") as a, open(prefix + ".txt") as b:
            assert a.read() == b.read()
    assert glob.glob(f"/dev/shm/rpvg_shm_{os.getpid()}_*") == []


@pytest.mark.parametrize(
    "model,extra",
    [
        ("transcripts", {}),
        ("strains", {}),
        ("haplotypes", {}),
        ("haplotype-transcripts", {"path_info": True}),
    ],
)
def test_matrix_mode_matches_sparse_mode(dataset, tmp_path, model, extra):
    # The multithreaded native matrix builder (DenseCluster path) must
    # produce byte-identical outputs to the sparse ReadPathProbs path
    # (forced here via write_probs, which needs the sparse rows).
    from rpvg_tpu.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")

    kwargs = dict(extra)
    if kwargs.pop("path_info", False):
        kwargs["path_info"] = dataset["info"]

    dense_prefix = str(tmp_path / f"dense_{model}")
    run_pipeline(base_config(dataset, dense_prefix, inference_model=model, **kwargs))

    sparse_prefix = str(tmp_path / f"sparse_{model}")
    run_pipeline(
        base_config(
            dataset, sparse_prefix, inference_model=model, write_probs=True, **kwargs
        )
    )

    with open(dense_prefix + ".txt") as a, open(sparse_prefix + ".txt") as b:
        assert a.read() == b.read()
