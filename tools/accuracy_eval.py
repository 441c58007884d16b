#!/usr/bin/env python
"""Statistical accuracy evaluation against simulated ground truth.

The reference's correctness at the output level is established in its
paper (Sibbesen et al., Nature Methods 2023) on simulated data with
known expression; this is the same experiment run end-to-end through
rpvg_tpu: simulate fragments from a pantranscriptome with known
per-path abundances, quantify, and score the estimates.

Usage: python tools/accuracy_eval.py [--pairs N] [--transcripts N]
Prints one metrics line per inference model.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def evaluate(
    num_pairs: int = 50000,
    num_transcripts: int = 1500,
    seed: int = 11,
    with_errors: bool = False,
    score_not_qual: bool = True,
    gene_panel: bool = False,
    multipath_dag: bool = False,
):
    """Returns {model: metrics} for the two abundance models.

    Metrics: spearman (all paths), spearman_expressed (true count > 0),
    mard_expressed (mean absolute relative difference on expressed
    paths), false_mass (estimated count mass on truly unexpressed
    paths / total), detected_frac (expressed paths with estimate > 0).

    `with_errors=True, score_not_qual=False` evaluates the reference's
    DEFAULT configuration — quality-adjusted scoring over reads with
    quality-driven sequencing errors (src/main.cpp:385).  `gene_panel`
    uses the gene-structured panel (isoforms sharing exons, real
    multimapping) instead of isolated transcripts.
    """
    from rpvg_tpu import sim
    from rpvg_tpu.pipeline import PipelineConfig, run_pipeline

    if gene_panel:
        panel = sim.build_gene_panel(
            num_genes=max(1, num_transcripts // 7),
            isoforms_per_gene=7,
            num_haplotypes=4,
            exons_per_gene=10,
            exon_length=120,
            variant_sites=3,
            seed=seed,
        )
    else:
        panel = sim.build_panel(
            num_transcripts=num_transcripts,
            num_haplotypes=4,
            exons_per_transcript=5,
            exon_length=120,
            variant_sites=2,
            seed=seed,
        )
    rng = np.random.default_rng(seed + 1)
    num_paths = len(panel.path_names)
    # Diploid-consistent truth: per transcript, expression comes from
    # exactly two of the four panel haplotypes (what the
    # haplotype-transcripts model assumes about a real sample), with
    # transcript-level expression drawn sparse.
    num_haps = 4
    num_tx = num_paths // num_haps
    tx_weight = rng.dirichlet(np.ones(num_tx) * 0.4)
    abundances = np.zeros(num_paths)
    # A sample carries ONE diplotype per locus: the haplotype pair is
    # drawn per gene and shared by its isoforms (per isolated transcript
    # in the flat panel) — the assumption the nested model makes.
    gene_of_tx = [
        panel.info[panel.path_names[tx * num_haps]][0][:9] for tx in range(num_tx)
    ]
    hap_pair_of_gene = {}
    for tx in range(num_tx):
        gene = gene_of_tx[tx]
        if gene not in hap_pair_of_gene:
            hap_pair_of_gene[gene] = rng.choice(num_haps, size=2, replace=False)
        hap_pair = hap_pair_of_gene[gene]
        split = rng.dirichlet(np.ones(2))
        for hap, w in zip(hap_pair, split):
            abundances[tx * num_haps + hap] = tx_weight[tx] * w
    records, true_counts = sim.simulate_read_pairs(
        panel, num_pairs, read_length=100, frag_mean=250, frag_sd=25,
        abundances=abundances, seed=seed + 2, with_errors=with_errors,
        multipath_dag=multipath_dag,
    )

    out_dir = tempfile.mkdtemp(prefix="rpvg_acc_")
    aln_path = os.path.join(out_dir, "aln.json")
    sim.write_alignment_json(records, aln_path)
    info_path = os.path.join(out_dir, "info.tsv")
    panel.write_info_tsv(info_path)

    name_to_idx = {name: i for i, name in enumerate(panel.path_names)}
    results = {}
    for model in ("transcripts", "haplotype-transcripts"):
        prefix = os.path.join(out_dir, model)
        config = PipelineConfig(
            graph=panel.graph,
            paths=panel.paths_index,
            alignments=aln_path,
            output_prefix=prefix,
            inference_model=model,
            path_info=info_path if model == "haplotype-transcripts" else None,
            threads=2,
            rng_seed=42,
            score_not_qual=score_not_qual,
        )
        run_pipeline(config)

        est = np.zeros(num_paths)
        with open(prefix + ".txt") as handle:
            header = handle.readline().rstrip("\n").split("\t")
            count_col = header.index("ReadCount")
            for line in handle:
                fields = line.rstrip("\n").split("\t")
                idx = name_to_idx.get(fields[0])
                if idx is not None:
                    est[idx] += float(fields[count_col])

        truth = true_counts.astype(np.float64)
        expressed = truth > 0
        mard = float(
            np.mean(
                np.abs(est[expressed] - truth[expressed])
                / np.maximum(truth[expressed], 1.0)
            )
        )
        results[model] = {
            "spearman": spearman(est, truth),
            "spearman_expressed": spearman(est[expressed], truth[expressed]),
            "mard_expressed": mard,
            "false_mass": float(est[~expressed].sum() / max(est.sum(), 1e-12)),
            "detected_frac": float((est[expressed] > 0).mean()),
            "total_est": float(est.sum()),
            "total_true": float(truth.sum()),
        }
    return results


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=50000)
    parser.add_argument("--transcripts", type=int, default=1500)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument(
        "--qual", action="store_true",
        help="reference-default regime: reads with quality-driven errors, "
        "quality-adjusted scoring",
    )
    parser.add_argument(
        "--gene-panel", action="store_true",
        help="gene-structured panel (isoforms sharing exons)",
    )
    parser.add_argument(
        "--multipath-dag", action="store_true",
        help="mpmap-shaped subpath DAGs with scored allele alternatives",
    )
    args = parser.parse_args()
    results = evaluate(
        args.pairs, args.transcripts, args.seed,
        with_errors=args.qual, score_not_qual=not args.qual,
        gene_panel=args.gene_panel, multipath_dag=args.multipath_dag,
    )
    for model, metrics in results.items():
        line = " ".join(f"{key}={value:.4f}" for key, value in metrics.items())
        print(f"{model}: {line}")
    return 0


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    rc = main()
    os._exit(rc)
