#!/usr/bin/env python
"""Device cost of the batched EM fixed point on the bench dataset's
bucket mix (one GPU).

    python tools/em_profile.py [--pairs N] [--transcripts N] [--trace-dir DIR]

Records the EM inputs of a `transcripts` CLI run with every cluster
routed to the device, pads them into the buckets run_batched_em uses,
and reports, each after a warm-up call:

* the whole mix at the production setting (--max-em-its 10000,
  --max-rel-em-conv 1e-3) in float32 and float64;
* the cost of one while-loop iteration per bucket (fixed iteration
  count, convergence off);
* from a jax.profiler trace of one fixed-iteration pass over the mix:
  device kernels per iteration, device busy time, and the share of the
  traced window in which no kernel ran.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXED_ITS = 500


def device_blocks(inputs, plan, dtype):
    import jax.numpy as jnp

    from rpvg_tpu.infer.batching import pad_em_block

    return [
        tuple(jnp.asarray(a) for a in pad_em_block(inputs, chunk, R_pad, C_pad, dtype))
        for chunk, R_pad, C_pad in plan
    ]


def run_mix(blocks, its, conv):
    """Solve every block once; returns wall seconds and iterations."""
    import jax
    import jax.numpy as jnp

    from rpvg_tpu.infer.em import _em_solve_batched

    t0 = time.perf_counter()
    outs = [
        _em_solve_batched(p, c, m, jnp.int32(its), p.dtype.type(conv)) for p, c, m in blocks
    ]
    jax.block_until_ready(outs)
    return time.perf_counter() - t0, [int(o[2]) for o in outs]


def run_production(blocks):
    """The mix as dispatch_em_device runs it (staged caps 128, 1024,
    10000 at --max-rel-em-conv 1e-3, results copied to the host)."""
    from rpvg_tpu.infer.em import em_abundances_batched

    t0 = time.perf_counter()
    for p, c, m in blocks:
        em_abundances_batched(p, c, m, 10000, 1e-3)
    return time.perf_counter() - t0


def busy_and_idle(trace_dir):
    """(kernel events, busy seconds, window seconds) over the GPU planes
    of the newest trace under trace_dir."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            print(f"  trace line {plane.name} / {line.name}: {len(events)} events")
            if line.name.startswith("Stream"):
                intervals += [(e.start_ns, e.end_ns) for e in events]
    if not intervals:
        return 0, 0.0, 0.0
    intervals.sort()
    busy, cur_start, cur_end = 0.0, *intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = intervals[-1][1] - intervals[0][0]
    return len(intervals), busy * 1e-9, max(window, 1) * 1e-9


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=100000)
    parser.add_argument("--transcripts", type=int, default=9000)
    parser.add_argument("--trace-dir", default=os.path.join(REPO, "chiprun_out", "em_trace"))
    args = parser.parse_args()

    import jax

    import chip_smoke
    from rpvg_tpu.infer import batching

    try:
        chip_smoke.device_check(1)
    except chip_smoke.CheckFailed as exc:
        print(exc, file=sys.stderr)
        return 1
    work_dir = os.path.join(REPO, "smoke_data", "profile")
    os.makedirs(work_dir, exist_ok=True)
    data_dir = chip_smoke.make_data(args.pairs, args.transcripts)
    with chip_smoke.Env(RPVG_TPU_HYBRID_EM_AREA="0"):
        with chip_smoke.Recorder([(batching, "dispatch_em_device")]) as rec:
            chip_smoke.run_gpu_cli(
                chip_smoke.cli_args(data_dir, "transcripts", os.path.join(work_dir, "tr")),
                "transcripts, all on device (recording)",
            )
    inputs = []
    for call_args, _ in rec.calls["dispatch_em_device"]:
        inputs += [call_args[0][i] for i in call_args[1]]
    plan = batching.em_chunk_plan(inputs, range(len(inputs)))
    useful = sum(p.size for p, _ in inputs)
    padded = sum(
        len(chunk) and batching._ceil_pow2(len(chunk), floor=1) * R * C for chunk, R, C in plan
    )
    print(f"mix: {len(inputs)} clusters in {len(plan)} chunks, "
          f"{useful} useful / {padded} padded matrix elements")

    for label, dtype in (
        ("float32", np.float32),
        ("float64", np.float64),
        ("float32 (again)", np.float32),
    ):
        blocks = device_blocks(inputs, plan, dtype)
        run_production(blocks)  # compile + warm
        prod = [run_production(blocks) for _ in range(3)]
        run_mix(blocks, FIXED_ITS, 0.0)
        fixed, _ = run_mix(blocks, FIXED_ITS, 0.0)
        _, its = run_mix(blocks, 10000, 1e-3)
        print(
            f"em mix {label}: production setting {min(prod) * 1e3:.2f} ms "
            f"(runs {', '.join(f'{t * 1e3:.2f}' for t in prod)} ms; one-stage iterations "
            f"per chunk max {max(its)}, sum {sum(its)}); fixed {FIXED_ITS} its "
            f"{fixed * 1e3:.2f} ms = {fixed / FIXED_ITS * 1e6:.1f} us per iteration over "
            f"{len(blocks)} chunks"
        )
    blocks = device_blocks(inputs, plan, np.float32)
    run_mix(blocks, FIXED_ITS, 0.0)
    for (chunk, R_pad, C_pad), block in sorted(
        zip(plan, blocks), key=lambda pb: -pb[1][0].size
    )[:6]:
        t, _ = run_mix([block], FIXED_ITS, 0.0)
        print(f"  bucket B={block[0].shape[0]} R={R_pad} C={C_pad}: "
              f"{t / FIXED_ITS * 1e6:.1f} us per iteration")

    with jax.profiler.trace(args.trace_dir):
        wall, _ = run_mix(blocks, FIXED_ITS, 0.0)
    kernels, busy, window = busy_and_idle(args.trace_dir)
    print(
        f"trace of {FIXED_ITS} fixed iterations over {len(blocks)} chunks: wall "
        f"{wall * 1e3:.2f} ms, {kernels} device kernels "
        f"({kernels / (FIXED_ITS * len(blocks)):.1f} per chunk-iteration), device busy "
        f"{busy * 1e3:.2f} ms of a {window * 1e3:.2f} ms device window: idle share "
        f"{1 - busy / window if window else float('nan'):.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
