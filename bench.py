#!/usr/bin/env python
"""Benchmark: end-to-end quantification throughput on a synthetic
pantranscriptome (the reference's bundled example is 100k read pairs
over a 36,120-path panel at ~1,700 read-pairs/s on 4 CPU threads;
binary inputs are stripped from the snapshot, so an equivalent workload
is synthesised here).

Prints ONE JSON line:
  {"metric": "read_pairs_per_s", "value": N, "unit": "pairs/s",
   "vs_baseline": N / 1700, "platform": ..., "device_kind": ...}

Design notes:
* the measured section is the full pipeline (projection -> clustering ->
  probabilities -> batched inference -> outputs);
* each window runs in a child process with a hard timeout, alternating
  a CPU window and a GPU window; every window is labelled with the
  platform and device kind its child reports, and a GPU window whose
  child finds no GPU fails the benchmark.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

BASELINE_PAIRS_PER_S = 1700.0


def make_dataset(num_pairs: int, num_transcripts: int, out_dir: str,
                 qual: bool = False, cli_inputs: bool = False) -> None:
    """Generate the reference-example-shaped dataset once (shared by
    every backend attempt): a four-haplotype GENE-STRUCTURED
    pantranscriptome with `haplotype-transcripts` inputs — the bundled
    example is 100k pairs over a 36,120-path whole-transcriptome panel.
    Isoforms of a gene share exon and allele nodes, so reads multimap
    across isoform x haplotype paths and clusters are power-law sized
    (hundreds of reads x dozens of paths at the head), matching the
    regime the reference's size-sorted cluster scheduling exists for;
    expression is a sparse Dirichlet over genes like real RNA-seq.
    `cli_inputs` also writes the graph and panel as JSON files for the
    command-line entry."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pickle

    from rpvg_tpu import sim
    from rpvg_tpu.alignments import parse_multipath_alignment
    from rpvg_tpu.io import rpa
    from rpvg_tpu.native import native_available

    panel = sim.build_gene_panel(
        num_genes=max(1, round(num_transcripts / 7)),
        isoforms_per_gene=7,
        num_haplotypes=4,
        exons_per_gene=10,
        exon_length=120,
        variant_sites=3,
        seed=5,
    )
    # `qual` = the reference's DEFAULT regime (quality-adjusted scoring,
    # src/main.cpp:385): quality-driven sequencing errors + per-base
    # qualities + GSSW qual-adjusted scores.
    # Multipath subpath DAGs over the variant bubbles: reads crossing a
    # site carry scored alternatives for every allele, like real mpmap
    # output — the multipath DFS machinery runs at full scale.
    records, _ = sim.simulate_read_pairs(
        panel, num_pairs, read_length=100, frag_mean=250, frag_sd=25, seed=17,
        abundances=sim.gene_abundances(panel, seed=7), with_errors=qual,
        multipath_dag=True,
    )

    if native_available():
        alns = [parse_multipath_alignment(r) for r in records]
        pairs = list(zip(alns[0::2], alns[1::2]))
        rpa.write_fragments(
            os.path.join(out_dir, "bench_aln.rpa"), pairs,
            is_multipath=True, is_paired=True, frag_mean=250.0, frag_sd=25.0,
        )
    else:
        sim.write_alignment_json(records, os.path.join(out_dir, "bench_aln.json"))
    panel.write_info_tsv(os.path.join(out_dir, "bench_info.tsv"))
    if cli_inputs:
        panel.write_graph_json(os.path.join(out_dir, "bench_graph.json"))
        panel.write_panel_json(os.path.join(out_dir, "bench_panel.json"))
    with open(os.path.join(out_dir, "panel.pkl"), "wb") as handle:
        pickle.dump(panel, handle)


def run_workload(num_pairs: int, num_transcripts: int, data_dir: str,
                 qual: bool = False, runs: int = 10) -> dict:
    """Measure the pipeline end-to-end from prebuilt binary inputs,
    exactly as the reference measures from its prebuilt .gamp."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import multiprocessing
    import pickle

    from rpvg_tpu.pipeline import PipelineConfig, run_pipeline

    with open(os.path.join(data_dir, "panel.pkl"), "rb") as handle:
        panel = pickle.load(handle)

    rpa_path = os.path.join(data_dir, "bench_aln.rpa")
    aln_path = rpa_path if os.path.exists(rpa_path) else os.path.join(
        data_dir, "bench_aln.json"
    )

    config = PipelineConfig(
        graph=panel.graph,
        paths=panel.paths_index,
        alignments=aln_path,
        output_prefix=os.path.join(data_dir, "bench_out"),
        inference_model="haplotype-transcripts",
        path_info=os.path.join(data_dir, "bench_info.tsv"),
        threads=min(8, multiprocessing.cpu_count()),
        rng_seed=42,
        score_not_qual=not qual,
    )

    # Ten runs, best kept: the first pays one-time jit
    # tracing/compiles (amortised away in production by the persistent
    # XLA compile cache), the rest measure steady state — best-of damps
    # the +-30% burst noise observed on small shared hosts (three runs
    # proved too few: one noisy burst can still cover all of them; at
    # ~2s per run, ten runs are cheap insurance).
    elapsed = []
    for _ in range(runs):
        start = time.perf_counter()
        stats = run_pipeline(config)
        elapsed.append(time.perf_counter() - start)

    import jax

    device = jax.devices()[0]
    return {
        "num_pairs": num_pairs,
        "elapsed_s": min(elapsed),
        "cold_elapsed_s": elapsed[0],
        "pairs_per_s": num_pairs / min(elapsed),
        "num_clusters": stats["num_clusters"],
        "num_fragment_lists": stats["num_fragment_lists"],
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
    }


def child_main() -> None:
    if os.environ.get("RPVG_TPU_FORCE_CPU") == "1":
        import jax

        jax.config.update("jax_platforms", "cpu")
    args = json.loads(sys.argv[2])
    result = run_workload(
        args["num_pairs"], args["num_transcripts"], args["data_dir"],
        qual=args.get("qual", False), runs=args.get("runs", 10),
    )
    print(json.dumps(result), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=100000)
    parser.add_argument("--transcripts", type=int, default=9000)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument(
        "--skip-forced-device", action="store_true",
        help="skip the forced-device diagnostic window",
    )
    parser.add_argument(
        "--qual", action="store_true",
        help="reference-default regime: quality-driven sequencing errors "
        "with quality-adjusted scoring (score_not_qual=False)",
    )
    args = parser.parse_args()

    data_dir = tempfile.mkdtemp(prefix="rpvg_bench_")
    print(f"bench: generating dataset ({args.pairs} pairs) ...", file=sys.stderr)
    make_dataset(args.pairs, args.transcripts, data_dir, qual=args.qual)

    def attempt(extra_env, runs=10):
        env = dict(os.environ)
        env.update(extra_env)
        payload = json.dumps(
            {
                "num_pairs": args.pairs,
                "num_transcripts": args.transcripts,
                "data_dir": data_dir,
                "qual": args.qual,
                "runs": runs,
            }
        )
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", payload],
                capture_output=True, text=True, timeout=args.timeout, env=env,
            )
        except subprocess.TimeoutExpired:
            return None, "timeout"
        if proc.returncode != 0:
            return None, proc.stderr[-2000:]
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                continue
        return None, "no result line"

    # Alternating windows (cpu, gpu, cpu, gpu), best kept per platform:
    # both platforms share the same host pipeline, so slow drift on a
    # shared host would otherwise bias whichever window landed quieter.
    best = {}
    failed = False
    for _ in range(2):
        for want, extra_env in (("cpu", {"RPVG_TPU_FORCE_CPU": "1"}), ("gpu", {})):
            result, err = attempt(extra_env)
            if result is None:
                print(f"bench: {want} window failed ({err})", file=sys.stderr)
                failed = True
                continue
            if result["platform"] != want:
                print(
                    f"bench: {want} window ran on {result['platform']} "
                    f"({result['device_kind']})", file=sys.stderr,
                )
                failed = True
                continue
            if want not in best or result["pairs_per_s"] > best[want]["pairs_per_s"]:
                best[want] = result

    # Forced-device diagnostic (not a headline candidate): route ALL
    # inference to the GPU (RPVG_TPU_HYBRID_EM_AREA=0 disables the
    # hybrid EM split, RPVG_TPU_HYBRID_DIPLOID_WORK=0 sends diploid
    # scoring too).
    forced_env = {"RPVG_TPU_HYBRID_EM_AREA": "0", "RPVG_TPU_HYBRID_DIPLOID_WORK": "0"}
    forced = None
    if not args.skip_forced_device and "gpu" in best:
        forced, err = attempt(forced_env, runs=3)
        if forced is None:
            print(f"bench: forced-device window failed ({err})", file=sys.stderr)

    import shutil

    shutil.rmtree(data_dir, ignore_errors=True)
    if failed or not best:
        return 1

    result = max(best.values(), key=lambda r: r["pairs_per_s"])
    for key, value in sorted(result.items()):
        print(f"bench: {key} = {value}", file=sys.stderr)
    out = {
        "metric": "read_pairs_per_s",
        "value": round(result["pairs_per_s"], 2),
        "unit": "pairs/s",
        "vs_baseline": round(result["pairs_per_s"] / BASELINE_PAIRS_PER_S, 4),
        "platform": result["platform"],
        "device_kind": result["device_kind"],
        "windows": {
            f"{r['platform']} ({r['device_kind']})": round(r["pairs_per_s"], 2)
            for r in best.values()
        },
    }
    if forced is not None:
        out["forced_device"] = {
            "pairs_per_s": round(forced["pairs_per_s"], 2),
            "elapsed_s": round(forced["elapsed_s"], 3),
            "runs": 3,
            "env": forced_env,
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child_main()
    else:
        sys.exit(main())
