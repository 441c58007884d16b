"""The accelerator decision (rpvg_tpu/backend.py) and the device path it
switches on.

With ``backend.device_enabled`` monkeypatched to True, XLA on the CPU
runs exactly the code an accelerator runs: float32 padded buckets, the
device Gibbs sampler, escalation to the device.  Each result is held to
the native float64 kernels within the tolerances chip_smoke.py states
for the card."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rpvg_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_platform():
    backend.reset_for_tests()
    backend.WORK.clear()
    yield
    backend.reset_for_tests()
    backend.WORK.clear()


@pytest.fixture
def device_on(monkeypatch):
    """Turn the device path on while XLA keeps running on the CPU."""
    monkeypatch.setattr(backend, "device_enabled", lambda: True)
    from rpvg_tpu.infer.batching import native_em_available

    if not native_em_available():
        pytest.skip("native library unavailable")


@pytest.mark.parametrize(
    "platform, enabled, dtype",
    [
        ("cpu", False, np.float64),
        ("gpu", True, np.float32),
        ("cuda", True, np.float32),
        ("rocm", True, np.float32),
    ],
)
def test_predicate_and_dtype_per_platform(monkeypatch, platform, enabled, dtype):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.platform() == platform
    assert backend.device_enabled() is enabled
    assert backend.device_dtype() is dtype


@pytest.mark.parametrize("name, pinned", [("gpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu")])
def test_pin_platform_names_one_jax_platform(monkeypatch, name, pinned):
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda key, value: updates.append((key, value)))
    backend.pin_platform(name)
    assert updates == [("jax_platforms", pinned)]


def test_platform_is_resolved_once(monkeypatch):
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: calls.append(1) or "cpu")
    assert [backend.platform() for _ in range(3)] == ["cpu"] * 3
    assert len(calls) == 1


def test_failed_platform_raises_one_line(monkeypatch):
    def boom():
        raise RuntimeError("Unable to initialize backend 'cuda'\nlong detail")

    monkeypatch.setattr(jax, "default_backend", boom)
    with pytest.raises(backend.BackendUnavailable) as info:
        backend.platform()
    assert str(info.value) == "JAX platform unavailable: Unable to initialize backend 'cuda'"


def _small_dataset(tmp_path):
    from rpvg_tpu import sim

    panel = sim.build_panel(
        num_transcripts=3, num_haplotypes=2, exons_per_transcript=2,
        exon_length=80, variant_sites=1, seed=5,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 80, read_length=60, frag_mean=150, frag_sd=12, seed=7,
    )
    paths = {}
    for name, write in (
        ("graph", panel.write_graph_json),
        ("paths", panel.write_panel_json),
    ):
        paths[name] = str(tmp_path / f"{name}.json")
        write(paths[name])
    paths["alignments"] = str(tmp_path / "aln.json")
    sim.write_alignment_json(records, paths["alignments"])
    return paths


@pytest.mark.parametrize("how", ["--backend", "JAX_PLATFORMS", "--multiprocess"])
def test_missing_gpu_is_rc1_without_fallback(tmp_path, how):
    """A GPU that is asked for and absent: one ERROR line, rc 1, no
    output files, no CPU run."""
    data = _small_dataset(tmp_path)
    prefix = str(tmp_path / "out")
    env = dict(os.environ, JAX_PLATFORMS="")
    cmd = [
        sys.executable, "-m", "rpvg_tpu.cli", "-g", data["graph"], "-p", data["paths"],
        "-a", data["alignments"], "-o", prefix, "-i", "transcripts", "-r", "1",
        "--score-not-qual",
    ]
    if how == "--backend":
        cmd += ["--backend", "gpu"]
    elif how == "--multiprocess":
        # The platform starts after the workers fork, and still fails.
        cmd += ["--backend", "gpu", "--multiprocess", "2"]
    else:
        env["JAX_PLATFORMS"] = "cuda"
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    errors = [line for line in proc.stderr.splitlines() if line.startswith("ERROR")]
    assert len(errors) == 1 and "JAX platform unavailable" in errors[0]
    assert "Traceback" not in proc.stderr
    assert not [p for p in os.listdir(tmp_path) if p.startswith("out")]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache sits in the checkout's .jax_cache/."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("RPVG_TPU_NO_COMPILE_CACHE", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = "import jax, rpvg_tpu; print(jax.config.jax_compilation_cache_dir)"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = proc.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path / env_dir)
    else:
        assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")


def _em_clusters(seed=3, n=24):
    rng = np.random.default_rng(seed)
    inputs = []
    for _ in range(n):
        R = int(rng.integers(3, 90))
        C = int(rng.integers(2, 20))
        probs = rng.random((R, C)) ** 3
        probs /= probs.sum(axis=1, keepdims=True)
        inputs.append((probs, rng.integers(1, 9, R).astype(np.float64)))
    return inputs


def test_batched_em_device_path_matches_native(device_on, monkeypatch):
    """float32 device buckets vs the float64 C++ kernel at a fixed
    iteration count: rounding differences only (rtol 1e-4, atol 1e-6 on
    fractions)."""
    from rpvg_tpu.infer import batching

    monkeypatch.setenv("RPVG_TPU_HYBRID_EM_AREA", "0")
    inputs = _em_clusters()
    seen = []
    orig = batching.em_abundances_batched
    monkeypatch.setattr(
        batching, "em_abundances_batched",
        lambda probs, *a, **k: seen.append(probs.dtype) or orig(probs, *a, **k),
    )
    dev = batching.run_batched_em(inputs, 150, 0.0)
    host = batching.run_native_em(inputs, 150, 0.0)
    assert seen and set(seen) == {np.dtype(np.float32)}
    assert backend.WORK["em.device"] == len(inputs)
    for (dc, dn), (hc, hn), (_, counts) in zip(dev, host, inputs):
        total = counts.sum()
        np.testing.assert_allclose(
            np.append(dc, dn) / total, np.append(hc, hn) / total, rtol=1e-4, atol=1e-6
        )


def test_diploid_device_path_matches_native(device_on, monkeypatch):
    from rpvg_tpu.infer import posteriors

    monkeypatch.setenv("RPVG_TPU_HYBRID_DIPLOID_WORK", "0")
    rng = np.random.default_rng(8)
    inputs = []
    for _ in range(10):
        R, P = int(rng.integers(4, 60)), int(rng.integers(2, 12))
        probs = rng.random((R, P)) ** 2
        noise = rng.random(R) * 1e-3
        inputs.append((probs, noise, rng.integers(1, 6, R).astype(np.float64), [1] * P))
    dev = posteriors.diploid_posteriors_batched(inputs, 1e-3)
    host = posteriors._diploid_posteriors_native(inputs, 1e-3)
    assert backend.WORK["diploid.device"] == len(inputs)
    for (dg, dp), (hg, hp) in zip(dev, host):
        assert dg == hg
        np.testing.assert_allclose(dp, hp, rtol=1e-4, atol=1e-9)
    scores = posteriors.gather_pair_scores(
        posteriors.dispatch_pair_scores(inputs, range(len(inputs))), inputs
    )
    native = posteriors._native_pair_scores(inputs)
    for idx, matrix in scores:
        np.testing.assert_allclose(matrix, native[idx], rtol=1e-5)


def _gibbs_jobs(shapes, seed=21):
    rng = np.random.default_rng(seed)
    jobs = []
    for R, P in shapes:
        probs = rng.random((R, P + 1)) * 0.5
        probs /= probs.sum(axis=1, keepdims=True)
        counts = rng.integers(1, 12, size=R).astype(np.float64)
        total = float(counts.sum())
        jobs.append((probs, counts, np.full(P, total / (P + 1)), total / (P + 1), total))
    return jobs, [np.asarray(jax.random.PRNGKey(i)) for i in range(len(jobs))]


def test_readcount_gibbs_device_path_matches_native(device_on, monkeypatch):
    """Device (threefry, float32) vs native (mt19937, float64) samplers:
    the same distribution, per-path means within 6 standard errors."""
    from rpvg_tpu.infer import readcount_gibbs as rg

    monkeypatch.setenv("RPVG_TPU_HYBRID_EM_AREA", "0")
    jobs, keys = _gibbs_jobs(((50, 5), (30, 3)))
    dev = rg.run_batched_gibbs(jobs, keys, 300, 20)
    host = rg.run_native_gibbs(jobs, keys, 300, 20)
    assert backend.WORK["gibbs.device"] == len(jobs)
    for (dn, dp), (hn, hp) in zip(dev, host):
        assert dp.shape == hp.shape
        for a, b in [(dn, hn)] + [(dp[:, p], hp[:, p]) for p in range(dp.shape[1])]:
            se = np.sqrt(a.var() / len(a) + b.var() / len(b))
            assert abs(a.mean() - b.mean()) <= 6 * se + 1e-9


@pytest.mark.parametrize(
    "cutoff, on_host",
    [(None, [0, 1, 2]), ("0", []), ("100", [1, 2]), ("1000", [0, 1, 2])],
)
def test_readcount_gibbs_follows_the_em_hybrid_cutoff(device_on, monkeypatch, cutoff, on_host):
    """On an accelerator, clusters below RPVG_TPU_HYBRID_EM_AREA sample
    on the native sampler, bitwise as run_native_gibbs does; the rest
    sample on the device, with per-job sample counts honoured."""
    from rpvg_tpu.infer import readcount_gibbs as rg

    if cutoff is not None:
        monkeypatch.setenv("RPVG_TPU_HYBRID_EM_AREA", cutoff)
    jobs, keys = _gibbs_jobs(((40, 4), (12, 3), (9, 2)))
    samples = [6, 4, 5]
    out = rg.run_batched_gibbs(jobs, keys, samples, 3)
    assert backend.WORK["gibbs.host"] == len(on_host)
    assert backend.WORK["gibbs.device"] == len(jobs) - len(on_host)
    native = rg.run_native_gibbs(jobs, keys, samples, 3)
    for idx, ((noise, paths), (n_noise, n_paths)) in enumerate(zip(out, native)):
        assert paths.shape == n_paths.shape == (samples[idx], jobs[idx][0].shape[1] - 1)
        assert noise.shape == (samples[idx],)
        if idx in on_host:
            np.testing.assert_array_equal(paths, n_paths)
            np.testing.assert_array_equal(noise, n_noise)
        np.testing.assert_allclose(noise + paths.sum(axis=1), jobs[idx][4], rtol=1e-5)


def test_escalations_go_to_the_device(device_on, monkeypatch, tmp_path):
    """On an accelerator the bounded-EM escalations of the default
    haplotype-transcripts path run on the device; on the CPU they stay
    on the host, bitwise equal to the uninterrupted native run.  The
    device run agrees with it within the convergence tolerance."""
    from rpvg_tpu import sim
    from rpvg_tpu.alignments import parse_multipath_alignment
    from rpvg_tpu.pipeline import PipelineConfig, run_pipeline

    panel = sim.build_gene_panel(
        num_genes=8, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=80, variant_sites=2, seed=5,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1500, read_length=80, frag_mean=200, frag_sd=20, seed=17,
        abundances=sim.gene_abundances(panel, seed=3),
    )
    alns = [
        (parse_multipath_alignment(a), parse_multipath_alignment(b))
        for a, b in zip(records[0::2], records[1::2])
    ]
    info = str(tmp_path / "info.tsv")
    panel.write_info_tsv(info)

    def run(tag):
        prefix = str(tmp_path / tag)
        run_pipeline(
            PipelineConfig(
                graph=panel.graph, paths=panel.paths_index, alignments=alns,
                output_prefix=prefix, inference_model="haplotype-transcripts",
                path_info=info, threads=2, rng_seed=42, score_not_qual=True,
                frag_mean=200.0, frag_sd=20.0,
            )
        )
        with open(prefix + ".txt") as handle:
            rows = [line.split("\t") for line in handle.read().splitlines()[1:]]
        return np.array([float(r[5]) for r in rows])

    monkeypatch.setenv("RPVG_TPU_EM_BOUND", "4")
    on_device = run("device")
    assert backend.WORK["em.device"] > 0
    monkeypatch.setattr(backend, "device_enabled", lambda: False)
    backend.WORK.clear()
    on_host = run("host")
    assert backend.WORK["em.device"] == 0
    monkeypatch.delenv("RPVG_TPU_EM_BOUND")
    uninterrupted = run("plain")
    np.testing.assert_array_equal(on_host, uninterrupted)
    assert on_device.sum() == pytest.approx(uninterrupted.sum(), rel=1e-6)
    np.testing.assert_allclose(on_device, uninterrupted, rtol=2e-2, atol=0.05)


@pytest.mark.parametrize(
    "kernel",
    ["em", "pair_scores", "pair_scores_batched", "pair_scores_block", "group_scores",
     "gibbs_conditionals", "mesh_pair_scores"],
)
def test_device_contractions_ask_for_highest_precision(kernel):
    """Every contraction in the device kernels carries
    precision=HIGHEST, so a GPU never rounds it through TF32.  The
    batched kernels sum with backend.fixed_order_sum instead and hold
    no contraction at all."""
    import jax.numpy as jnp

    from rpvg_tpu.infer import posteriors
    from rpvg_tpu.parallel import mesh

    f = jnp.float32
    R, P = 8, 4
    ones = lambda *shape: jnp.ones(shape, f)  # noqa: E731
    if kernel in ("em", "pair_scores_batched", "group_scores"):
        batched, args = _batched_kernel(kernel)
        fn = lambda: batched(*args)  # noqa: E731
    elif kernel == "pair_scores":
        fn = lambda: posteriors._diploid_pair_scores(  # noqa: E731
            ones(R, P), ones(R), ones(R), jnp.zeros(P, f)
        )
    elif kernel == "pair_scores_block":
        fn = lambda: posteriors._diploid_pair_scores_block(  # noqa: E731
            ones(R, P), ones(R), ones(R), jnp.zeros(P, f), ones(R, 2), jnp.zeros(2, f)
        )
    elif kernel == "gibbs_conditionals":
        fn = lambda: posteriors._gibbs_chains(  # noqa: E731
            jax.random.PRNGKey(0), ones(R, P), ones(R), ones(R), jnp.zeros(P, f), 2, 2, 3,
        )
    else:
        score = mesh.sharded_diploid_scores(mesh.make_mesh(1))
        fn = lambda: score(ones(R, P), ones(R), ones(R), jnp.zeros(P, f))  # noqa: E731
    text = str(jax.make_jaxpr(fn)())
    dots = text.count("dot_general")
    if kernel in ("em", "pair_scores_batched", "group_scores", "gibbs_conditionals"):
        assert dots == 0
        return
    assert dots > 0
    assert text.count("precision=(Precision.HIGHEST, Precision.HIGHEST)") >= dots


def _batched_kernel(kernel, B=8, R=24, P=6):
    """(jitted batched kernel, its (B, ...) float32 arguments)."""
    import jax.numpy as jnp

    from rpvg_tpu.infer import em, posteriors, readcount_gibbs

    rng = np.random.default_rng(12)
    probs = rng.random((B, R, P)).astype(np.float32)
    counts = rng.integers(0, 7, (B, R)).astype(np.float32)
    noise = (rng.random((B, R)) * 1e-3).astype(np.float32)
    masks = np.ones((B, P), np.float32)
    if kernel == "em":
        return (
            lambda p, c, m: em._em_solve_batched(p, c, m, jnp.int32(60), np.float32(0)),
            (probs, counts, masks),
        )
    if kernel == "pair_scores_batched":
        return posteriors._diploid_pair_scores_batched, (
            probs, noise, counts, np.zeros((B, P), np.float32),
        )
    if kernel == "group_scores":
        idx = jnp.asarray(np.array([[0, 1, 2], [1, 1, 5], [3, 4, 4]], np.int32))
        return (lambda p, n, c: posteriors._group_scores_chunk(p, n, c, idx)), (
            probs, noise, counts,
        )
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(B)])
    fracs = np.full((B, P), 1.0 / P, np.float32)
    return (
        lambda k, p, c, fr, m: readcount_gibbs._gibbs_read_counts_vmapped(
            k, p, c, fr, m, 1.0, 3, 2
        ),
        (keys, probs, counts, fracs, masks),
    )


@pytest.mark.parametrize(
    "kernel", ["em", "pair_scores_batched", "group_scores", "readcount_gibbs"]
)
def test_batched_kernels_are_batch_size_invariant_on_cpu(kernel):
    """Each cluster's result is bitwise the same in a batch of 8 and in
    a batch of 2 (what one of four devices holds when autoshard splits
    the batch): the property behind the mesh's byte-identical outputs.
    The kernels' sums run in a fixed order, so the GPU has it too;
    tests/test_gpu.py checks it on the card."""
    fn, args = _batched_kernel(kernel)
    full = jax.tree.leaves(fn(*args))
    part = jax.tree.leaves(fn(*[a[2:4] for a in args]))
    for whole, piece in zip(full, part):
        if np.ndim(whole) and np.shape(whole)[0] == 8:
            np.testing.assert_array_equal(np.asarray(whole)[2:4], np.asarray(piece))


@pytest.mark.parametrize("shape, axis", [((5, 8), 1), ((7, 3, 12), 1), ((33,), 0), ((4, 1), 1)])
def test_fixed_order_sum_matches_sum(shape, axis):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = np.asarray(backend.fixed_order_sum(x, axis))
    assert got.shape == np.sum(x, axis=axis).shape
    np.testing.assert_allclose(got, x.astype(np.float64).sum(axis=axis), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n, padded", [(5, 8), (8, 16), (13, 64)])
def test_fixed_order_sum_ignores_zero_padding(n, padded):
    """Zero padding of the summed axis, as the buckets pad clusters,
    leaves every bit of the sum unchanged."""
    x = np.random.default_rng(n).random((6, n)).astype(np.float32)
    wide = np.zeros((6, padded), np.float32)
    wide[:, :n] = x
    np.testing.assert_array_equal(
        np.asarray(backend.fixed_order_sum(x, 1)), np.asarray(backend.fixed_order_sum(wide, 1))
    )
