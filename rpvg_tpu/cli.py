"""Command-line interface mirroring the reference tool's option surface
(/root/reference/src/main.cpp:364-419).

Inputs: graph as vg-Graph JSON (.json[.gz]), paths as a serialized
gbwt::GBWT container (.gbwt, the reference's panel input) or the native
panel JSON (.json[.gz]), alignments as binary vg streams (.gam/.gamp,
decoded by the vendored wire codec) or protobuf-JSON lines (.json[.gz],
`vg view -a` style) — single-path (gam) with --single-path, multipath
(gamp) by default.
"""

from __future__ import annotations

import argparse
import sys

from .pipeline import PipelineConfig, run_pipeline


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rpvg-tpu",
        description=(
            "rpvg_tpu — infers path posterior probabilities and abundances "
            "from variation graph read alignments (JAX engine)"
        ),
    )

    required = parser.add_argument_group("required")
    required.add_argument(
        "-g", "--graph", required=True,
        help="graph filename (.xg container or vg-Graph JSON)",
    )
    required.add_argument(
        "-p", "--paths", required=True,
        help="path panel index filename (.gbwt container or panel JSON)",
    )
    required.add_argument(
        "-a", "--alignments", required=True,
        help="alignment filename (.gam/.gamp binary, JSON lines, or .rpa)",
    )
    required.add_argument("-o", "--output-prefix", required=True, help="output filename prefix")
    required.add_argument(
        "-i",
        "--inference-model",
        required=True,
        choices=["haplotypes", "transcripts", "strains", "haplotype-transcripts"],
    )

    general = parser.add_argument_group("general")
    general.add_argument("-t", "--threads", type=int, default=1)
    general.add_argument("-r", "--rng-seed", type=int, default=None)
    general.add_argument(
        "--multiprocess",
        type=int,
        default=0,
        metavar="N",
        help=(
            "run the fragment pass across N worker processes "
            "(single-host stand-in for the multi-host runner; outputs are "
            "byte-identical to a plain run)"
        ),
    )
    general.add_argument(
        "--backend",
        default=None,
        metavar="PLATFORM",
        help=(
            "JAX platform to run inference on (e.g. 'cpu', 'gpu'); a "
            "platform that cannot start is an error, never a fallback"
        ),
    )

    alignment = parser.add_argument_group("alignment")
    alignment.add_argument(
        "-e", "--strand-specific", default="unstranded", choices=["unstranded", "fr", "rf"]
    )
    alignment.add_argument("-u", "--single-path", action="store_true")
    alignment.add_argument("-s", "--single-end", action="store_true")
    alignment.add_argument("-l", "--long-reads", action="store_true")
    alignment.add_argument("--score-not-qual", action="store_true")

    fragment = parser.add_argument_group("fragment")
    fragment.add_argument("-m", "--frag-mean", type=float, default=None)
    fragment.add_argument("-d", "--frag-sd", type=float, default=None)
    fragment.add_argument("--max-num-sd-frag", type=int, default=10)

    probability = parser.add_argument_group("probability")
    probability.add_argument("-b", "--write-probs", action="store_true")
    probability.add_argument("--max-par-offset", type=int, default=4)
    probability.add_argument("--max-score-diff", type=int, default=20)
    probability.add_argument("--filt-best-score", type=float, default=0.9)
    probability.add_argument("--use-allelic-mapq", action="store_true")
    probability.add_argument("--min-noise-prob", type=float, default=1e-4)
    probability.add_argument("--prob-precision", type=float, default=1e-8)
    probability.add_argument("--path-node-cluster", action="store_true")

    haplotyping = parser.add_argument_group("haplotyping")
    haplotyping.add_argument("-y", "--ploidy", type=int, default=2)
    haplotyping.add_argument("-f", "--path-info", default=None)
    haplotyping.add_argument("--min-hap-prob", type=float, default=0.001)
    haplotyping.add_argument("--ind-hap-inference", action="store_true")
    haplotyping.add_argument("--use-hap-gibbs", action="store_true")

    quantification = parser.add_argument_group("quantification")
    quantification.add_argument("-n", "--num-gibbs-samples", type=int, default=0)
    quantification.add_argument("--max-em-its", type=int, default=10000)
    quantification.add_argument("--max-rel-em-conv", type=float, default=0.001)
    quantification.add_argument("--gibbs-thin-its", type=int, default=25)

    return parser


def main(argv=None) -> int:
    from .backend import BackendUnavailable, pin_platform, require_platform

    args = build_parser().parse_args(argv)

    if args.backend is not None:
        # Start the requested platform now, before the fragment pass, so
        # a missing device fails in seconds rather than after it.  The
        # multiprocess driver starts it itself, right after it forks its
        # workers, so that none of them inherits a device runtime.
        try:
            if args.multiprocess > 1:
                pin_platform(args.backend)
            else:
                require_platform(args.backend)
        except BackendUnavailable as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1

    if args.frag_mean is None != args.frag_sd is None:
        print("ERROR: both --frag-mean and --frag-sd must be given.", file=sys.stderr)
        return 1
    if args.inference_model == "haplotype-transcripts" and args.path_info is None:
        print(
            "ERROR: --path-info is required for haplotype-transcripts inference.",
            file=sys.stderr,
        )
        return 1
    if args.ploidy == 0:
        print("ERROR: --ploidy cannot be 0.", file=sys.stderr)
        return 1

    import time

    rng_seed = args.rng_seed if args.rng_seed is not None else int(time.time())
    from . import __version__

    print(f"Running rpvg_tpu ({__version__})", file=sys.stderr)
    print(f"Random number generator seed: {rng_seed}", file=sys.stderr)

    config = PipelineConfig(
        graph=args.graph,
        paths=args.paths,
        alignments=args.alignments,
        output_prefix=args.output_prefix,
        inference_model=args.inference_model,
        threads=args.threads,
        rng_seed=rng_seed,
        library_type=args.strand_specific,
        single_path=args.single_path,
        single_end=args.single_end,
        long_reads=args.long_reads,
        score_not_qual=args.score_not_qual,
        frag_mean=args.frag_mean,
        frag_sd=args.frag_sd,
        max_num_sd_frag=args.max_num_sd_frag,
        write_probs=args.write_probs,
        max_par_offset=args.max_par_offset,
        max_score_diff=args.max_score_diff,
        filt_best_score=args.filt_best_score,
        use_allelic_mapq=args.use_allelic_mapq,
        min_noise_prob=args.min_noise_prob,
        prob_precision=args.prob_precision,
        path_node_cluster=args.path_node_cluster,
        ploidy=args.ploidy,
        path_info=args.path_info,
        min_hap_prob=args.min_hap_prob,
        ind_hap_inference=args.ind_hap_inference,
        use_hap_gibbs=args.use_hap_gibbs,
        num_gibbs_samples=args.num_gibbs_samples,
        max_em_its=args.max_em_its,
        max_rel_em_conv=args.max_rel_em_conv,
        gibbs_thin_its=args.gibbs_thin_its,
    )
    from .pipeline import PipelineInputError

    try:
        if args.multiprocess > 1:
            from .parallel.multihost import run_pipeline_multiprocess

            run_pipeline_multiprocess(config, args.multiprocess)
        else:
            run_pipeline(config)
    except (PipelineInputError, BackendUnavailable) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
