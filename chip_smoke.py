#!/usr/bin/env python
"""Smoke test of the inference half on one NVIDIA GPU.

    python chip_smoke.py                 # one card, phases 1-4
    python chip_smoke.py --four-cards    # four cards, the data-mesh phase only

One process uses the card at a time: a short child checks for a GPU,
a second runs the --multiprocess CLI path, then this process takes the
card for everything else.  The CPU reference runs are child processes
pinned to the CPU.

1. Device check: JAX's first device must be a GPU.  Prints its kind,
   the device count, and nvidia-smi's name and power limit.
2. Kernels at real widths, on the cluster matrices of the bench dataset
   (bench.make_dataset, 100k read pairs over ~36,000 paths): the batched
   EM, the diploid pair scores and the read-count Gibbs sampler on the
   device, each against the native float64 kernels.
3. End to end through the CLI: haplotype-transcripts, transcripts -n 8
   (every cluster's EM and Gibbs on the device) and haplotypes, each
   compared with the same command run on the CPU; and
   haplotype-transcripts with --multiprocess 2, run as a plain CLI
   process that forks its workers before it starts the GPU, which must
   be byte-identical to the single-process run.
4. The card-only tests: pytest -m gpu.

--four-cards runs haplotype-transcripts and transcripts -n 8 over the
4-way data mesh and again with RPVG_TPU_AUTOSHARD=0, and requires
byte-identical outputs.  Then haplotypes with the pair-tensor guard
lowered, so the model-axis-sharded pair scoring runs; it is a different
summation than the single device's blocked scoring, and must agree with
it within the end-to-end tolerances.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or on any failed check, the script exits non-zero and
prints no such line.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Fixed-iteration EM: float32 on the device against float64 on the
# host, same update, so the difference is rounding alone.
EM_CHECK_ITS = 200
EM_RTOL, EM_ATOL = 1e-4, 1e-6
# Pair log-likelihoods are sums of R negative terms: float32 rounding
# stays far below this relative bound.
PAIR_RTOL = 1e-5
# Read-count Gibbs: the device (threefry) and host (mt19937) samplers
# draw different bits, so they are compared as distributions: per-path
# means within this many standard errors of each other.
GIBBS_MEAN_SE = 6.0
GIBBS_SAMPLES, GIBBS_THIN, GIBBS_MAX_WIDTH = 100, 25, 64
# End to end at --max-rel-em-conv 1e-3: EM preserves the read total
# exactly, and per-path counts may move by the convergence tolerance,
# which leaves the ranking of expressed paths all but unchanged.
COUNT_RTOL = 1e-6
SPEARMAN_MIN = 0.9999


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise CheckFailed(message)


def worst_error(got, want, rtol, atol=0.0):
    """(worst |got-want| / (atol + rtol*|want|), max abs error, max
    relative error) over entries; entries equal in both (including
    matching infinities) count as exact.  A ratio <= 1 passes."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        raise CheckFailed(f"shape {got.shape} != {want.shape}")
    same = got == want
    with np.errstate(invalid="ignore"):
        diff = np.where(same, 0.0, np.abs(got - want))
    if not np.isfinite(diff).all():
        return float("inf"), float("inf"), float("inf")
    scale = np.abs(want)
    ratio = diff / (atol + rtol * scale) if (atol or rtol) else diff
    rel = np.where(same, 0.0, diff / np.maximum(scale, np.finfo(np.float64).tiny))
    if diff.size == 0:
        return 0.0, 0.0, 0.0
    return float(ratio.max()), float(diff.max()), float(rel.max())


def read_table(path):
    """Tab-separated output table -> (header, list of rows)."""
    with open(path) as handle:
        header = handle.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in handle if line.strip()]
    return header, rows


def _keyed_values(path):
    """{row key: value} for the table's main quantity: ReadCount where
    the model reports counts, else the haplotyping probability.  The key
    is the row's name columns."""
    header, rows = read_table(path)
    value_col = "ReadCount" if "ReadCount" in header else "HaplotypingProbability"
    col = header.index(value_col)
    names = [i for i, name in enumerate(header) if name.startswith("Name")]
    values = {}
    for row in rows:
        values[tuple(row[i] for i in names)] = float(row[col])
    return value_col, values


def spearman(a, b) -> float:
    from scipy.stats import spearmanr

    return float(spearmanr(a, b).correlation)


def compare_tables(got_path, want_path) -> dict:
    """Compare two runs' main output tables: relative error of the
    summed value, and the Spearman correlation over rows that are
    non-zero in either run (a row missing from one counts as zero)."""
    column, got = _keyed_values(got_path)
    _, want = _keyed_values(want_path)
    keys = sorted(set(got) | set(want))
    g = np.array([got.get(k, 0.0) for k in keys])
    w = np.array([want.get(k, 0.0) for k in keys])
    expressed = (g > 0) | (w > 0)
    total = float(w.sum())
    return {
        "column": column,
        "rows": len(keys),
        "expressed": int(expressed.sum()),
        "sum_rel_err": abs(float(g.sum()) - total) / max(total, 1e-300),
        "spearman": spearman(g[expressed], w[expressed]) if expressed.sum() > 1 else 1.0,
        "max_abs_err": float(np.abs(g - w).max()) if keys else 0.0,
    }


def table_passes(cmp: dict) -> bool:
    return cmp["sum_rel_err"] <= COUNT_RTOL and cmp["spearman"] >= SPEARMAN_MIN


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def output_files(prefix):
    return sorted(glob.glob(prefix + ".txt") + glob.glob(prefix + "_*"))


def same_bytes(prefix_a, prefix_b) -> bool:
    files_a, files_b = output_files(prefix_a), output_files(prefix_b)
    if [f[len(prefix_a):] for f in files_a] != [f[len(prefix_b):] for f in files_b]:
        return False
    for fa, fb in zip(files_a, files_b):
        if open(fa, "rb").read() != open(fb, "rb").read():
            return False
    return bool(files_a)


def log(message: str) -> None:
    print(message, flush=True)


# ---------------------------------------------------------------- phases


def probe_device(want_count: int) -> None:
    """Fail fast where JAX finds no GPU, from a child process: this one
    must not open the card before the --multiprocess check."""
    code = "import jax; d = jax.devices(); print(d[0].platform, len(d))"
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
    )
    found = proc.stdout.split()
    check(
        proc.returncode == 0 and found[:1] == ["gpu"],
        f"no GPU: JAX reports {(proc.stdout.strip() or proc.stderr.strip()[-300:])!r}",
    )
    check(int(found[1]) >= want_count, f"need {want_count} GPUs, JAX sees {found[1]}")


def device_check(want_count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise CheckFailed(f"no GPU: JAX runs on {devices[0].platform!r}")
    if len(devices) < want_count:
        raise CheckFailed(f"need {want_count} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"device: {devices[0].device_kind} x{len(devices)} ({devices[0].platform})")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    return devices


def make_data(pairs: int, transcripts: int) -> str:
    """The bench dataset of this size, made once into its own directory
    (bench.make_dataset writes fixed file names)."""
    sys.path.insert(0, REPO)
    import bench

    data_dir = os.path.join(REPO, "smoke_data", "data", f"{pairs}_{transcripts}")
    marker = os.path.join(data_dir, "done")
    if not os.path.exists(marker):
        os.makedirs(data_dir, exist_ok=True)
        t0 = time.perf_counter()
        bench.make_dataset(pairs, transcripts, data_dir, cli_inputs=True)
        open(marker, "w").close()
        log(f"dataset: {pairs} pairs, {transcripts} transcripts "
            f"({time.perf_counter() - t0:.1f}s)")
    return data_dir


def cli_args(data_dir, model, prefix, extra=()):
    args = [
        "-g", os.path.join(data_dir, "bench_graph.json"),
        "-p", os.path.join(data_dir, "bench_panel.json"),
        "-a", os.path.join(data_dir, "bench_aln.rpa"),
        "-o", prefix, "-i", model, "-r", "42", "--score-not-qual",
        "-t", str(min(8, os.cpu_count() or 1)),
    ]
    if model == "haplotype-transcripts":
        args += ["-f", os.path.join(data_dir, "bench_info.tsv")]
    return args + list(extra)


class Recorder:
    """Wraps module functions to keep the arguments of every call."""

    def __init__(self, targets):
        self.targets = targets  # [(module, name)]
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def __enter__(self):
        for module, name in self.targets:
            orig = getattr(module, name)
            self.saved.append((module, name, orig))

            def wrapper(*args, _orig=orig, _name=name, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _orig(*args, **kwargs)

            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, orig in self.saved:
            setattr(module, name, orig)


class Env:
    """Temporarily set environment variables (None removes one)."""

    def __init__(self, **values):
        self.values = values
        self.saved = {}

    def __enter__(self):
        for key, value in self.values.items():
            self.saved[key] = os.environ.get(key)
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value

    def __exit__(self, *exc):
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def run_gpu_cli(args, label):
    import jax

    from rpvg_tpu import backend
    from rpvg_tpu.cli import main

    backend.WORK.clear()
    t0 = time.perf_counter()
    rc = main(args)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{label}: cli rc={rc}")
    work = dict(backend.WORK)
    device = sum(v for k, v in work.items() if k.endswith(".device"))
    host = sum(v for k, v in work.items() if k.endswith(".host"))
    stats = jax.devices()[0].memory_stats() or {}
    log(
        f"e2e {label}: wall {wall:.2f}s, device work {device}, host work {host} "
        f"{work}, device peak bytes so far {stats.get('peak_bytes_in_use')}"
    )
    check(device > 0, f"{label}: the device ran no work")
    return wall


def run_cpu_cli(args, label):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rpvg_tpu.cli"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    check(proc.returncode == 0, f"{label} on cpu: rc={proc.returncode}\n{proc.stderr[-2000:]}")
    log(f"cpu reference {label}: wall {time.perf_counter() - t0:.2f}s")


def check_em(em_inputs):
    import jax.numpy as jnp

    from rpvg_tpu.infer import batching, em

    with Env(RPVG_TPU_HYBRID_EM_AREA="0"):
        t0 = time.perf_counter()
        dev = batching.run_batched_em(em_inputs, EM_CHECK_ITS, 0.0)
        t_dev = time.perf_counter() - t0
    host = batching.run_native_em(em_inputs, EM_CHECK_ITS, 0.0)
    worst = (0.0, 0.0, 0.0)
    for (d_counts, d_noise), (h_counts, h_noise), (_, counts) in zip(dev, host, em_inputs):
        total = float(counts.sum())
        err = worst_error(
            np.append(d_counts, d_noise) / total,
            np.append(h_counts, h_noise) / total,
            EM_RTOL, EM_ATOL,
        )
        worst = max(worst, err)
    log(
        f"kernel em: {len(em_inputs)} clusters, float32 device vs float64 native, "
        f"precision {em.backend.MATMUL_PRECISION}, {EM_CHECK_ITS} fixed iterations "
        f"({t_dev:.2f}s incl. compile): worst abs {worst[1]:.3e} (atol {EM_ATOL}), "
        f"worst ratio {worst[0]:.3f} of rtol {EM_RTOL}/atol {EM_ATOL}"
    )
    check(worst[0] <= 1.0, "em: device fractions outside tolerance")

    # Memory of the largest chunk's compiled fixed point.
    chunk, R_pad, C_pad = max(
        batching.em_chunk_plan(em_inputs, range(len(em_inputs))),
        key=lambda plan: len(plan[0]) * plan[1] * plan[2],
    )
    probs, counts, masks = batching.pad_em_block(em_inputs, chunk, R_pad, C_pad, np.float32)
    compiled = em._em_solve_batched.lower(
        jnp.asarray(probs), jnp.asarray(counts), jnp.asarray(masks),
        jnp.int32(EM_CHECK_ITS), np.float32(0.001),
    ).compile()
    log(f"kernel em largest bucket {probs.shape}: {compiled.memory_analysis()}")


def check_pairs(dip_inputs):
    from rpvg_tpu.infer import posteriors

    pending = posteriors.dispatch_pair_scores(dip_inputs, range(len(dip_inputs)))
    dev = posteriors.gather_pair_scores(pending, dip_inputs)
    host = posteriors._native_pair_scores(dip_inputs)
    check(host is not None, "pair scores: native library unavailable")
    worst = (0.0, 0.0, 0.0)
    for idx, scores in dev:
        worst = max(worst, worst_error(scores, host[idx], PAIR_RTOL))
    widest = max(p.shape for p, _, _, _ in dip_inputs)
    log(
        f"kernel diploid pair scores: {len(dip_inputs)} clusters (widest R,P {widest}), "
        f"float32 device vs float64 native: worst rel {worst[2]:.3e} (rtol {PAIR_RTOL})"
    )
    check(worst[0] <= 1.0, "pair scores outside tolerance")


def check_gibbs(em_inputs):
    """The three largest clusters up to GIBBS_MAX_WIDTH paths, sampled
    from their native EM estimates as the pipeline does."""
    import jax
    from scipy.stats import ks_2samp

    from rpvg_tpu.infer import batching
    from rpvg_tpu.infer import readcount_gibbs as rg

    picked = sorted(
        (item for item in em_inputs if item[0].shape[1] <= GIBBS_MAX_WIDTH),
        key=lambda item: -item[0].size,
    )[:3]
    jobs = []
    for (probs, counts), (path_counts, noise) in zip(
        picked, batching.run_native_em(picked, 10000, 0.001)
    ):
        jobs.append((probs, counts, path_counts, noise, float(counts.sum())))
    job_keys = [np.asarray(jax.random.PRNGKey(i)) for i in range(len(jobs))]
    from rpvg_tpu import backend

    backend.WORK.clear()
    t0 = time.perf_counter()
    with Env(RPVG_TPU_HYBRID_EM_AREA="0"):
        dev = rg.run_batched_gibbs(jobs, job_keys, GIBBS_SAMPLES, GIBBS_THIN)
    t_dev = time.perf_counter() - t0
    check(backend.WORK["gibbs.device"] == len(jobs), "gibbs: the device sampler did not run")
    host = rg.run_native_gibbs(jobs, job_keys, GIBBS_SAMPLES, GIBBS_THIN)
    worst_se, min_p = 0.0, 1.0
    for (dn, dp), (hn, hp), job in zip(dev, host, jobs):
        total = job[4]
        for a, b in [(dn, hn)] + [(dp[:, p], hp[:, p]) for p in range(dp.shape[1])]:
            se = np.sqrt(a.var() / len(a) + b.var() / len(b))
            gap = abs(a.mean() - b.mean())
            if gap > 1e-6 * total:
                worst_se = max(worst_se, gap / max(se, 1e-300))
            if a.std() > 0 or b.std() > 0:
                min_p = min(min_p, ks_2samp(a, b).pvalue)
    shapes = [job[0].shape for job in jobs]
    log(
        f"kernel read-count gibbs: clusters {shapes}, {GIBBS_SAMPLES} samples thinned "
        f"{GIBBS_THIN} ({t_dev:.2f}s device): worst mean gap {worst_se:.2f} SE "
        f"(limit {GIBBS_MEAN_SE}), smallest KS p {min_p:.2e}"
    )
    check(worst_se <= GIBBS_MEAN_SE, "gibbs: device and host means disagree")


def phase_kernels(data_dir, work_dir):
    """Record the device entry points' inputs during two forced-device
    CLI runs, then check each kernel on them."""
    from rpvg_tpu.infer import batched_models, batching

    with Env(RPVG_TPU_HYBRID_EM_AREA="0", RPVG_TPU_HYBRID_DIPLOID_WORK="0"):
        with Recorder([(batching, "dispatch_em_device")]) as rec:
            run_gpu_cli(
                cli_args(data_dir, "transcripts", os.path.join(work_dir, "rec_tr")),
                "transcripts, all on device (recording)",
            )
        with Recorder([(batched_models, "diploid_posteriors_batched")]) as rec_dip:
            run_gpu_cli(
                cli_args(data_dir, "haplotypes", os.path.join(work_dir, "rec_hap")),
                "haplotypes, all on device (recording)",
            )
    em_inputs = []
    for args, kwargs in rec.calls["dispatch_em_device"]:
        cluster_inputs, indices = args[0], args[1]
        em_inputs += [cluster_inputs[i] for i in indices]
    dip_calls = rec_dip.calls["diploid_posteriors_batched"]
    check(em_inputs and dip_calls, "kernel inputs were not recorded")
    check_em(em_inputs)
    check_pairs([item for args, _ in dip_calls for item in args[0]])
    check_gibbs(em_inputs)


# (model, extra CLI arguments, environment of the GPU run).  At the
# bench's scale every transcripts cluster sits below the hybrid cutoff,
# where EM and read-count Gibbs run on the native kernels; the cutoff 0
# puts them all on the device.
E2E_MODELS = [
    ("haplotype-transcripts", [], {}),
    ("transcripts", ["-n", "8"], {"RPVG_TPU_HYBRID_EM_AREA": "0"}),
    ("haplotypes", [], {}),
]
MP_MODEL = "haplotype-transcripts"


def phase_fork(data_dir, work_dir):
    """haplotype-transcripts --multiprocess 2 as a plain CLI process,
    before this process opens the card: the driver forks its workers,
    then starts the GPU while they scan.  Returns the output prefix."""
    from rpvg_tpu.backend import initialised_platform

    check(initialised_platform() is None, "the card was opened before the fork check")
    prefix = os.path.join(work_dir, f"gpu_mp_{MP_MODEL}")
    args = cli_args(data_dir, MP_MODEL, prefix, ["--multiprocess", "2", "--backend", "gpu"])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rpvg_tpu.cli"] + args,
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    check(proc.returncode == 0, f"--multiprocess 2: rc={proc.returncode}\n{proc.stderr[-2000:]}")
    forked = "2 worker processes (fork)" in proc.stderr
    log(f"e2e {MP_MODEL} --multiprocess 2 --backend gpu (CLI process): wall "
        f"{time.perf_counter() - t0:.2f}s, workers forked before the GPU started: {forked}")
    check(forked, "the multiprocess driver did not fork its workers")
    return prefix


def phase_end_to_end(data_dir, work_dir, mp_prefix):
    for model, extra, env in E2E_MODELS:
        label = " ".join([model] + extra)
        gpu_prefix = os.path.join(work_dir, f"gpu_{model}")
        cpu_prefix = os.path.join(work_dir, f"cpu_{model}")
        with Env(**env):
            run_gpu_cli(cli_args(data_dir, model, gpu_prefix, extra), label)
        run_cpu_cli(cli_args(data_dir, model, cpu_prefix, extra), label)
        cmp = compare_tables(gpu_prefix + ".txt", cpu_prefix + ".txt")
        log(
            f"e2e {label} vs cpu: {cmp['column']} over {cmp['rows']} rows "
            f"({cmp['expressed']} non-zero): summed rel err {cmp['sum_rel_err']:.3e} "
            f"(limit {COUNT_RTOL}), spearman {cmp['spearman']:.6f} "
            f"(min {SPEARMAN_MIN}), max abs diff {cmp['max_abs_err']:.4g}"
        )
        check(table_passes(cmp), f"{label}: gpu output does not match the cpu run")

    identical = same_bytes(mp_prefix, os.path.join(work_dir, f"gpu_{MP_MODEL}"))
    log(f"e2e {MP_MODEL} --multiprocess 2 byte-identical to single process: {identical}")
    check(identical, "--multiprocess 2 outputs differ from the single-process run")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(REPO, "tests")])
    log(f"pytest -m gpu: rc {int(rc)}")
    check(int(rc) == 0, "card-only tests failed")


def phase_four_cards(data_dir, work_dir):
    from rpvg_tpu.infer import posteriors
    from rpvg_tpu.parallel import autoshard

    split = {"calls": 0, "split": 0}
    shard_batched = autoshard.shard_batched

    def counting_shard_batched(*arrays):
        n = autoshard.num_data_shards()
        split["calls"] += 1
        split["split"] += n > 1 and all(a.shape[0] % n == 0 for a in arrays)
        return shard_batched(*arrays)

    autoshard.shard_batched = counting_shard_batched
    try:
        for model, extra, env in E2E_MODELS[:2]:
            prefixes = {}
            for label, shard in (("mesh", None), ("single", "0")):
                with Env(RPVG_TPU_AUTOSHARD=shard, **env):
                    autoshard.data_mesh.cache_clear()
                    split.update(calls=0, split=0)
                    prefixes[label] = os.path.join(work_dir, f"{label}_{model}")
                    run_gpu_cli(cli_args(data_dir, model, prefixes[label], extra),
                                f"{model} {' '.join(extra)} {label}")
                    log(f"  {split['split']} of {split['calls']} batched dispatches "
                        f"split over {autoshard.num_data_shards()} devices")
                    if shard is None:
                        check(autoshard.num_data_shards() == 4, "data mesh does not span 4 GPUs")
                        check(split["split"] > 0, f"{model}: no dispatch was split over the mesh")
            autoshard.data_mesh.cache_clear()
            identical = same_bytes(prefixes["mesh"], prefixes["single"])
            cmp = compare_tables(prefixes["mesh"] + ".txt", prefixes["single"] + ".txt")
            log(
                f"four cards {model}: 4-way mesh vs one device: byte-identical {identical} "
                f"(summed rel err {cmp['sum_rel_err']:.3e}, max abs diff "
                f"{cmp['max_abs_err']:.3e} over {cmp['rows']} rows)"
            )
            check(identical, f"{model}: mesh outputs differ from single-device outputs")
    finally:
        autoshard.shard_batched = shard_batched

    calls = {"sharded": 0}
    orig = posteriors._pair_scores_sharded

    def counting(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls["sharded"] += out is not None
        return out

    posteriors._pair_scores_sharded = counting
    try:
        prefixes = {}
        for label, shard in (("mesh", None), ("single", "0")):
            with Env(RPVG_TPU_AUTOSHARD=shard, RPVG_TPU_PAIR_TENSOR_LIMIT="65536",
                     RPVG_TPU_HYBRID_DIPLOID_WORK="0"):
                autoshard.data_mesh.cache_clear()
                prefixes[label] = os.path.join(work_dir, f"{label}_pairs_haplotypes")
                run_gpu_cli(cli_args(data_dir, "haplotypes", prefixes[label]),
                            f"haplotypes lowered pair limit {label}")
                if label == "mesh":
                    check(calls["sharded"] > 0, "model-axis-sharded pair scoring never ran")
        autoshard.data_mesh.cache_clear()
    finally:
        posteriors._pair_scores_sharded = orig
    cmp = compare_tables(prefixes["mesh"] + ".txt", prefixes["single"] + ".txt")
    log(
        f"four cards haplotypes, {calls['sharded']} model-axis-sharded pair scorings: "
        f"vs blocked single-device scoring, summed rel err {cmp['sum_rel_err']:.3e}, "
        f"spearman {cmp['spearman']:.6f}, max abs diff {cmp['max_abs_err']:.3e}, "
        f"byte-identical {same_bytes(prefixes['mesh'], prefixes['single'])}"
    )
    check(table_passes(cmp), "sharded pair scoring disagrees with blocked scoring")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU data-mesh phase")
    parser.add_argument("--pairs", type=int, default=100000)
    parser.add_argument("--transcripts", type=int, default=9000)
    args = parser.parse_args(argv)
    want = 4 if args.four_cards else 1

    t_start = time.perf_counter()
    try:
        probe_device(want)
        sys.path.insert(0, REPO)
        import rpvg_tpu  # noqa: F401  (x64 and the compile cache)

        work_dir = os.path.join(REPO, "smoke_data", "four" if args.four_cards else "one")
        os.makedirs(work_dir, exist_ok=True)
        data_dir = make_data(args.pairs, args.transcripts)
        mp_prefix = None if args.four_cards else phase_fork(data_dir, work_dir)
        devices = device_check(want)
        if args.four_cards:
            phase_four_cards(data_dir, work_dir)
        else:
            phase_kernels(data_dir, work_dir)
            phase_end_to_end(data_dir, work_dir, mp_prefix)
            phase_gpu_tests()
    except CheckFailed as exc:
        print(f"FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(result_line(devices[0].platform, devices[0].device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
