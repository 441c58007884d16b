"""Backend failures are errors, and failed runs leave no outputs.

The reference cannot lose its compute device mid-run (its inference
loop is host code, src/main.cpp:827-998).  This engine resolves its JAX
platform once (rpvg_tpu/backend.py): a platform that cannot start makes
the CLI print one ERROR line and exit 1, never a silent CPU run, and a
failed run leaves NO partial outputs under the real names
(AtomicTextHandle: tmp + rename-on-close)."""

import glob
import os

import numpy as np
import pytest

from rpvg_tpu import backend, sim
from rpvg_tpu.pipeline import PipelineConfig, run_pipeline


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("backend_guard")
    panel = sim.build_panel(
        num_transcripts=2, num_haplotypes=2, exons_per_transcript=2,
        exon_length=80, variant_sites=1, seed=5,
    )
    abundances = np.array([0.4, 0.1, 0.3, 0.2])
    records, _ = sim.simulate_read_pairs(
        panel, 120, read_length=60, frag_mean=150, frag_sd=12,
        abundances=abundances, seed=7,
    )
    graph_path = str(tmp / "graph.json")
    panel_path = str(tmp / "panel.json")
    aln_path = str(tmp / "aln.json")
    panel.write_graph_json(graph_path)
    panel.write_panel_json(panel_path)
    sim.write_alignment_json(records, aln_path)
    return {"graph": graph_path, "paths": panel_path, "alignments": aln_path}


def _config(dataset, prefix, **overrides):
    kwargs = dict(
        graph=dataset["graph"],
        paths=dataset["paths"],
        alignments=dataset["alignments"],
        output_prefix=prefix,
        inference_model="transcripts",
        rng_seed=17,
        score_not_qual=True,
        write_probs=True,
        num_gibbs_samples=8,
    )
    kwargs.update(overrides)
    return PipelineConfig(**kwargs)


@pytest.fixture(autouse=True)
def _reset_backend_cache():
    backend.reset_for_tests()
    yield
    backend.reset_for_tests()


def test_raising_backend_init_exits_1_without_outputs(dataset, tmp_path, monkeypatch, capsys):
    """jax.default_backend() raising when the device half starts: the
    CLI prints one ERROR line, returns 1, and no output file exists."""
    import jax

    from rpvg_tpu.cli import main

    def boom():
        raise RuntimeError("Unable to initialize backend 'cuda': no device\ndetail")

    monkeypatch.setattr(jax, "default_backend", boom)
    prefix = str(tmp_path / "out")
    rc = main([
        "-g", dataset["graph"], "-p", dataset["paths"], "-a", dataset["alignments"],
        "-o", prefix, "-i", "transcripts", "-r", "17", "--score-not-qual",
        "-b", "-n", "8",
    ])
    assert rc == 1
    err = capsys.readouterr().err
    errors = [line for line in err.splitlines() if line.startswith("ERROR")]
    assert errors == [
        "ERROR: JAX platform unavailable: Unable to initialize backend 'cuda': no device"
    ]
    assert not glob.glob(prefix + "*")


def test_crash_mid_inference_leaves_no_partial_outputs(dataset, tmp_path, monkeypatch):
    """A genuine device-half failure propagates, but no partial output
    appears under a real output name and staging files are swept."""
    import rpvg_tpu.infer.batched_models as bm
    import rpvg_tpu.pipeline as pl

    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    for name in (
        "batched_transcripts",
        "batched_strains",
        "batched_haplotypes",
        "batched_haplotype_transcripts",
    ):
        monkeypatch.setattr(bm, name, boom)
    monkeypatch.setattr(pl, "ClusterRNG", boom)  # serial fallback path

    prefix = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="injected device failure"):
        run_pipeline(_config(dataset, prefix))

    assert not os.path.exists(prefix + ".txt")
    assert not os.path.exists(prefix + "_gibbs.txt.gz")
    assert not glob.glob(prefix + "*.tmp")
