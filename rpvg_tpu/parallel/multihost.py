"""Multi-host execution: data-parallel fragment sharding.

Scaling layout (BASELINE.json / SURVEY §2.3): the path index is
replicated per host, the alignment stream shards data-parallel across
hosts, each host runs its own fragment pass, and exactly two small
reductions cross hosts — the deduplicated fragment-list counts and the
fragment-length histogram (the reference's single-process
producer-consumer indexing thread, src/main.cpp:200-237, reborn as an
all-reduce).  Inference then proceeds on the merged index; clusters are
independent so per-cluster work needs no further communication beyond
the TPM normaliser sum.

Three drivers:

* :func:`run_pipeline_sharded` — in-process shard loop (deterministic,
  used by CI to prove shard-invariance byte-for-byte);
* :func:`run_pipeline_multiprocess` — one worker process per shard
  (one-host many-process stand-in for multi-host; workers return pickled
  shard indexes to rank 0);
* :func:`run_pipeline_distributed` — true multi-process execution over
  ``jax.distributed`` (Gloo collectives on CPU, NCCL between GPUs):
  sharded fragment pass, all-gathered dedup merge, strided per-process
  cluster inference, results gathered to process 0 — byte-identical to
  single-host.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

from ..pipeline import (
    FragmentIndex,
    PipelineConfig,
    build_finder,
    collect_fragments,
    load_inputs,
    resolve_pre_fragment_dist,
    run_inference_phases,
)


def _merge_shard_indexes(shards) -> FragmentIndex:
    merged = shards[0]
    for shard in shards[1:]:
        merged.merge_from(shard)
    return merged


def run_pipeline_sharded(config: PipelineConfig, num_shards: int) -> Dict:
    """Run the fragment pass as `num_shards` data-parallel shards (in
    process), merge, then run inference once.  Output is identical to
    the unsharded pipeline."""
    log = lambda msg: print(msg, file=sys.stderr)  # noqa: E731

    graph, paths_index = load_inputs(config)
    pre_dist = resolve_pre_fragment_dist(config)
    finder = build_finder(config, paths_index, pre_dist)

    shards = [
        collect_fragments(config, finder, pre_dist, shard=s, num_shards=num_shards)
        for s in range(num_shards)
    ]
    fragment_index = _merge_shard_indexes(shards)
    log(
        f"Merged {num_shards} fragment shards: "
        f"{len(fragment_index.entries)} distinct alignment path lists, "
        f"{fragment_index.unaligned_count} unaligned"
    )

    return run_inference_phases(
        config, paths_index, fragment_index, pre_dist, log, finder=finder
    )


# Parent-built state inherited by fork workers (copy-on-write: the path
# index, finder and config never pickle or rebuild per worker).
_FORK_STATE: Dict = {}

# Columnar shard dumps above this many bytes transfer through a tmpfs
# file (one memcpy to /dev/shm in the worker, a zero-copy memmap in the
# parent) instead of pickling through the Pool result pipe — at 1M
# pairs the pipe serialisation alone costs ~1s of the fragment pass.
_SHM_DIR = "/dev/shm"


def _shm_payload_min() -> int:
    import os

    env = os.environ.get("RPVG_TPU_SHM_PAYLOAD_MIN")
    return int(env) if env else 1 << 20


def _spill_columnar_payload(payload, shard: int):
    """Write a columnar shard payload into one tmpfs file; returns
    (path, descriptors, unaligned) or None to use the pipe.  Arrays are
    64-byte aligned so the parent's typed memmap views are exact."""
    import os
    import uuid

    *arrays, unaligned = payload
    arrays = [
        np.frombuffer(a, dtype=np.uint8)
        if isinstance(a, (bytes, bytearray))
        else np.ascontiguousarray(a)
        for a in arrays
    ]
    if sum(a.nbytes for a in arrays) < _shm_payload_min() or not os.path.isdir(
        _SHM_DIR
    ):
        return None
    path = os.path.join(
        _SHM_DIR, f"rpvg_shm_{os.getppid()}_{shard}_{uuid.uuid4().hex[:8]}.bin"
    )
    descs = []
    try:
        with open(path, "wb") as handle:
            offset = 0
            for arr in arrays:
                pad = (-offset) % 64
                if pad:
                    handle.write(b"\0" * pad)
                    offset += pad
                handle.write(memoryview(arr).cast("B"))
                descs.append((arr.dtype.str, arr.shape, offset))
                offset += arr.nbytes
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    return (path, descs, unaligned)


def _load_spilled_payload(spilled):
    """Memmap a worker's tmpfs payload file and unlink it immediately:
    the open mapping keeps the pages alive, so lifetime follows the
    returned views exactly (no cleanup path to get wrong)."""
    import os

    path, descs, unaligned = spilled
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    os.unlink(path)
    views = []
    for dtype_str, shape, offset in descs:
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        view = mm[offset : offset + count * dt.itemsize].view(dt).reshape(shape)
        views.append(view)
    return (*views, unaligned)


def _pin_worker_to_cpu():
    """Pool initializer: a fragment worker's JAX, should anything call
    it, runs on the CPU and never opens the parent's accelerator."""
    import jax

    jax.config.update("jax_platforms", "cpu")


def _shard_worker(args):
    import dataclasses
    import time as _time

    config, shard, num_shards, threads_per_worker = args
    # Workers share the configured threads evenly: running the full
    # config.threads inside every worker would oversubscribe the host
    # N*threads-fold (build_finder bakes config.threads into the native
    # finder, so the clamp must precede it).
    if config is not None and config.threads != threads_per_worker:
        config = dataclasses.replace(config, threads=threads_per_worker)
    if config is None:
        config, pre_dist, finder = _FORK_STATE["bundle"]
        if config.threads != threads_per_worker:
            config = dataclasses.replace(config, threads=threads_per_worker)
        # The parent built the bundle finder with ITS thread count (the
        # downstream phases own every core); in a shard worker the
        # native pass and dump run with this worker's share.  fork gave
        # this process a private copy-on-write _iparams, so the child
        # write never reaches the parent.
        if hasattr(finder, "_iparams"):
            finder._iparams[7] = threads_per_worker
    else:
        graph, paths_index = load_inputs(config)
        pre_dist = resolve_pre_fragment_dist(config)
        finder = build_finder(config, paths_index, pre_dist)
    scan_start = _time.perf_counter()
    index = collect_fragments(
        config, finder, pre_dist, shard=shard, num_shards=num_shards,
        columnar=True,
    )
    scan_s = _time.perf_counter() - scan_start
    from ..backend import initialised_platform

    # The scan is host code: a worker that opened an accelerator would
    # contend with the parent for its memory.
    assert initialised_platform() in (None, "cpu"), "a fragment worker opened a device"
    from ..pipeline import ColumnarFragmentIndex

    if isinstance(index, ColumnarFragmentIndex):
        # Ship the native columnar dump raw: no per-entry Python objects
        # cross the process boundary, and the parent's merge stays
        # columnar (fast inference path).
        cols = index.columnar
        payload = (
            bytes(cols.data), np.asarray(cols.counts),
            np.asarray(cols.anchors), np.asarray(cols.id_bounds),
            np.asarray(cols.all_ids), np.asarray(cols.raw_bounds),
            np.asarray(cols.histogram), int(cols.unaligned),
        )
        spilled = _spill_columnar_payload(payload, shard)
        if spilled is not None:
            return ("columnar_file", spilled, scan_s)
        return ("columnar", payload, scan_s)
    # Python-engine fallback: ship parsed entries.
    return (
        "entries",
        (
            list(index.entries.values()),
            index.frag_length_counts,
            index.unaligned_count,
        ),
        scan_s,
    )


def _native_shard_merge(payloads, pre_dist, is_single_end, max_threads=None):
    """Whole cross-shard merge through the threaded C++ kernels: dedup
    keyed on the canonical raw serialization (global first-seen order,
    counts summed) then a parallel gather of the merged blob / id runs /
    anchors.  Returns the merged ColumnarFragmentIndex, or None when
    the library is unavailable (the Python path below is the
    specification; measured ~2.0s -> ~0.1s at bench scale)."""
    import ctypes
    import os

    from ..native import ColumnarFragments, load_library, native_available
    from ..pipeline import ColumnarFragmentIndex

    if not native_available():
        return None
    lib = load_library()
    if lib is None:
        return None
    if not getattr(lib, "_merge_shards_configured", False):
        lib.rpvg_merge_columnar_shards.restype = ctypes.c_int64
        lib.rpvg_merge_columnar_shards.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rpvg_gather_merged_columnar.restype = None
        lib.rpvg_gather_merged_columnar.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._merge_shards_configured = True

    n_shards = len(payloads)
    keepalive = []  # hold buffer refs across the calls
    data_ptrs = (ctypes.c_void_p * n_shards)()
    rbound_ptrs = (ctypes.c_void_p * n_shards)()
    ibound_ptrs = (ctypes.c_void_p * n_shards)()
    ids_ptrs = (ctypes.c_void_p * n_shards)()
    anchor_ptrs = (ctypes.c_void_p * n_shards)()
    n_entries = np.empty(n_shards, dtype=np.int64)

    def as_c(arr, dtype):
        arr = np.ascontiguousarray(arr, dtype=dtype)
        keepalive.append(arr)
        return arr.ctypes.data_as(ctypes.c_void_p).value

    for si, (data, counts, anchors, id_bounds, all_ids, raw_bounds, _h, _u) in enumerate(payloads):
        # `data` is bytes (pipe payload) or a uint8 memmap view (tmpfs
        # payload), owned by `payloads` for the whole call, so the raw
        # pointer stays valid either way.
        if isinstance(data, (bytes, bytearray)):
            data_ptrs[si] = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
        else:
            data_arr = np.ascontiguousarray(data, dtype=np.uint8)
            keepalive.append(data_arr)
            data_ptrs[si] = ctypes.c_void_p(data_arr.ctypes.data)
        rbound_ptrs[si] = as_c(raw_bounds, np.int64)
        ibound_ptrs[si] = as_c(id_bounds, np.int64)
        ids_ptrs[si] = as_c(all_ids, np.int64)
        anchor_ptrs[si] = as_c(anchors, np.int64)
        n_entries[si] = counts.size

    # Respect the run's configured thread budget (a deliberately
    # thread-capped run must not fan the merge across all host cores).
    cap = max_threads if max_threads else (os.cpu_count() or 1)
    n_threads = int(min(16, max(1, cap)))
    total = int(n_entries.sum())
    out_shard = np.empty(total, dtype=np.int32)
    out_entry = np.empty(total, dtype=np.int64)
    out_counts = np.empty(total, dtype=np.int64)
    out_raw_lens = np.empty(total, dtype=np.int64)
    out_id_lens = np.empty(total, dtype=np.int64)
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    n = lib.rpvg_merge_columnar_shards(
        data_ptrs, rbound_ptrs, ibound_ptrs,
        as_i64(n_entries), n_shards, n_threads,
        out_shard.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_i64(out_entry), as_i64(out_counts),
        as_i64(out_raw_lens), as_i64(out_id_lens),
    )

    raw_bounds_m = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_raw_lens[:n], out=raw_bounds_m[1:])
    id_bounds_m = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_id_lens[:n], out=id_bounds_m[1:])
    blob = np.empty(int(raw_bounds_m[-1]), dtype=np.uint8)
    all_ids_m = np.empty(int(id_bounds_m[-1]), dtype=np.int64)
    anchors_m = np.empty(n, dtype=np.int64)
    counts_m = out_counts[:n].copy()
    lib.rpvg_gather_merged_columnar(
        data_ptrs, rbound_ptrs, ibound_ptrs, ids_ptrs, anchor_ptrs,
        out_shard.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_i64(out_entry), as_i64(counts_m),
        as_i64(raw_bounds_m), as_i64(id_bounds_m),
        n, n_threads,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        as_i64(all_ids_m), as_i64(anchors_m),
    )

    histogram = sum(p[6] for p in payloads)
    unaligned = sum(p[7] for p in payloads)
    cols = ColumnarFragments(
        blob.tobytes(), counts_m, anchors_m, id_bounds_m, all_ids_m,
        raw_bounds_m, histogram, unaligned,
    )
    return ColumnarFragmentIndex(cols, pre_dist, is_single_end)


def _merge_columnar_shards(payloads, pre_dist, is_single_end, max_threads=None):
    """Cross-shard dedup of native columnar dumps: entries keyed by their
    canonical raw serialization (minus the embedded count), counts
    summed and rewritten into the merged blob, located-id CSR and
    anchors gathered from the first-seen shard.  Everything downstream
    keeps the columnar fast path."""
    from ..native import ColumnarFragments
    from ..pipeline import ColumnarFragmentIndex

    native = _native_shard_merge(payloads, pre_dist, is_single_end, max_threads)
    if native is not None:
        return native

    key_index: Dict[bytes, int] = {}
    sel = []  # (shard, entry) first-seen
    merged_counts: list = []
    for si, (data, counts, _anchors, _idb, _ids, raw_bounds, _h, _u) in enumerate(payloads):
        mv = memoryview(data)
        rb = raw_bounds
        for e in range(counts.size):
            key = bytes(mv[int(rb[e]) + 8 : int(rb[e + 1])])
            idx = key_index.get(key)
            if idx is None:
                key_index[key] = len(merged_counts)
                sel.append((si, e))
                merged_counts.append(int(counts[e]))
            else:
                merged_counts[idx] += int(counts[e])

    n = len(merged_counts)
    counts_arr = np.asarray(merged_counts, dtype=np.int64)
    # Per-shard gathers of the selected entries' raw bytes and id runs.
    sel_shard = np.fromiter((s for s, _ in sel), np.int64, n)
    sel_entry = np.fromiter((e for _, e in sel), np.int64, n)
    blob_parts, id_parts = [], []
    anchors = np.empty(n, dtype=payloads[0][2].dtype) if n else np.empty(0, np.int64)
    raw_lens = np.empty(n, dtype=np.int64)
    id_lens = np.empty(n, dtype=np.int64)
    order = np.argsort(sel_shard, kind="stable")
    for si, payload in enumerate(payloads):
        data, counts, sh_anchors, idb, ids, rb, _h, _u = payload
        mine = order[sel_shard[order] == si]
        entries = sel_entry[mine]
        if entries.size == 0:
            continue
        data_arr = np.frombuffer(data, dtype=np.uint8)
        starts = rb[entries]
        lens = rb[entries + 1] - starts
        gather = np.repeat(starts, lens) + _run_aranges(lens)
        blob_parts.append((mine, data_arr[gather], lens))
        raw_lens[mine] = lens
        anchors[mine] = sh_anchors[entries]
        istarts = idb[entries]
        ilens = idb[entries + 1] - istarts
        igather = np.repeat(istarts, ilens) + _run_aranges(ilens)
        id_parts.append((mine, ids[igather], ilens))
        id_lens[mine] = ilens

    raw_bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(raw_lens, out=raw_bounds[1:])
    id_bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(id_lens, out=id_bounds[1:])
    blob = np.empty(int(raw_bounds[-1]), dtype=np.uint8)
    all_ids = np.empty(int(id_bounds[-1]), dtype=payloads[0][4].dtype)
    for mine, chunk, lens in blob_parts:
        dest = np.repeat(raw_bounds[mine], lens) + _run_aranges(lens)
        blob[dest] = chunk
    for mine, chunk, ilens in id_parts:
        dest = np.repeat(id_bounds[mine], ilens) + _run_aranges(ilens)
        all_ids[dest] = chunk
    # Rewrite the embedded count field (first 8 bytes of every entry)
    # with the merged totals — downstream consumers (matrix builder,
    # probability formatter) read counts from the blob.
    if n:
        le_counts = counts_arr.astype("<i8").view(np.uint8).reshape(n, 8)
        positions = raw_bounds[:-1, None] + np.arange(8)
        blob[positions] = le_counts

    histogram = sum(p[6] for p in payloads)
    unaligned = sum(p[7] for p in payloads)
    cols = ColumnarFragments(
        blob.tobytes(), counts_arr, anchors, id_bounds, all_ids,
        raw_bounds, histogram, unaligned,
    )
    return ColumnarFragmentIndex(cols, pre_dist, is_single_end)


def _run_aranges(lens: np.ndarray) -> np.ndarray:
    """Concatenated [0..len) ranges for variable-length runs
    (zero-length runs contribute nothing)."""
    lens = np.asarray(lens, dtype=np.int64)
    lens = lens[lens > 0]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    starts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    out[starts] = np.concatenate(([0], 1 - lens[:-1]))
    return np.cumsum(out)


def run_pipeline_multiprocess(config: PipelineConfig, num_workers: int) -> Dict:
    """Fragment pass across worker processes (multi-host stand-in).

    Start method: `fork` by default on platforms that have it — workers
    inherit the parent-built path index and finder copy-on-write, so
    per-worker startup is process spawn only (the workers run pure
    native/numpy code and never touch the JAX backend).  The parent
    forks before it starts its own JAX platform, which then comes up
    while the workers scan; a caller that already started an
    accelerator gets spawned workers instead, since its device
    runtime's threads make fork unsafe.  Workers are pinned to the CPU
    platform, so none ever opens the accelerator.  Override with
    RPVG_TPU_MP_CONTEXT=spawn (workers then rebuild state from the
    pickled config)."""
    import multiprocessing as mp
    import os as _os

    log = lambda msg: print(msg, file=sys.stderr)  # noqa: E731

    from ..native import set_thread_budget

    set_thread_budget(config.threads)

    graph, paths_index = load_inputs(config)
    pre_dist = resolve_pre_fragment_dist(config)

    import time as _time

    from ..backend import initialised_platform, platform

    can_fork = "fork" in mp.get_all_start_methods() and initialised_platform() in (
        None, "cpu",
    )
    ctx_name = _os.environ.get("RPVG_TPU_MP_CONTEXT", "fork" if can_fork else "spawn")
    ctx = mp.get_context(ctx_name)
    # Each worker gets an equal share of the configured threads: the
    # process axis carries the parallelism when workers >= threads (the
    # usual -t N --multiprocess N), while -t 4 --multiprocess 1 still
    # scans with 4 threads inside its lone worker.
    threads_per_worker = max(1, config.threads // num_workers)
    finder = None
    if ctx_name == "fork":
        finder = build_finder(config, paths_index, pre_dist)
        _FORK_STATE["bundle"] = (config, pre_dist, finder)
        worker_args = [
            (None, s, num_workers, threads_per_worker) for s in range(num_workers)
        ]
    else:
        worker_args = [
            (config, s, num_workers, threads_per_worker)
            for s in range(num_workers)
        ]

    from ..pipeline import submit_info_parse

    frag_start = _time.perf_counter()
    pool = ctx.Pool(num_workers, initializer=_pin_worker_to_cpu)
    log(f"Fragment pass: {num_workers} worker processes ({ctx_name})")
    # Overlap the info-TSV parse with the worker scan, exactly like the
    # single-process pipeline (shared helper so the arguments cannot
    # diverge between the two drivers).  Submitted AFTER the pool fork:
    # forking while a non-daemon thread runs can leave a child holding a
    # lock the thread owned at fork time; the parse is only consumed
    # post-merge in the parent, so it loses no overlap by starting here.
    info_future = submit_info_parse(config)
    try:
        # The parent's platform starts only now that the workers exist,
        # and overlaps their scan; one that cannot start ends the run.
        platform()
        shard_payloads = pool.map(_shard_worker, worker_args)
    except BaseException:
        # Workers that already spilled their payload to tmpfs leave
        # files behind when the pass dies — reclaim them (the success
        # path unlinks inside _load_spilled_payload).
        import glob as _glob
        import os as _os

        pool.terminate()
        for stray in _glob.glob(
            _os.path.join(_SHM_DIR, f"rpvg_shm_{_os.getpid()}_*")
        ):
            try:
                _os.unlink(stray)
            except OSError:
                pass
        raise
    finally:
        _FORK_STATE.pop("bundle", None)
        # Reap the workers OFF the critical path: Pool.terminate/join
        # blocks ~1.3s at bench scale (worker teardown + handler-thread
        # polling) while the merge and inference have everything they
        # need the moment map() returns.
        pool.close()
        import threading as _threading

        _threading.Thread(target=pool.join, daemon=True).start()
    fragment_pass_s = _time.perf_counter() - frag_start
    # Critical path of the distributed scan itself (per-worker startup —
    # interpreter spawn + index build — is a fixed cost amortised over
    # real workloads and overlapped on real pods).
    fragment_scan_s = max(payload[2] for payload in shard_payloads)

    # Rehydrate tmpfs-spilled columnar payloads (zero-copy memmap views;
    # each file is unlinked as it is mapped).  If any shard fails to
    # rehydrate, reclaim the remaining RAM-backed spill files before
    # propagating.
    try:
        shard_payloads = [
            ("columnar", _load_spilled_payload(body), scan)
            if kind == "columnar_file"
            else (kind, body, scan)
            for kind, body, scan in shard_payloads
        ]
    except BaseException:
        import glob as _glob
        import os as _os

        for stray in _glob.glob(
            _os.path.join(_SHM_DIR, f"rpvg_shm_{_os.getpid()}_*")
        ):
            try:
                _os.unlink(stray)
            except OSError:
                pass
        raise

    merge_start = _time.perf_counter()
    if all(payload[0] == "columnar" for payload in shard_payloads):
        if len(shard_payloads) == 1:
            # One shard is already deduplicated by the worker: adopt its
            # dump directly.  Re-keying every entry through the
            # cross-shard merge costs ~1.1s at bench scale for nothing
            # — it also inflated the 1-worker baseline every scaling
            # ratio is computed against.
            from ..native import ColumnarFragments
            from ..pipeline import ColumnarFragmentIndex

            data, *rest = shard_payloads[0][1]
            if not isinstance(data, (bytes, bytearray)):
                # tmpfs payloads arrive as memmap views; the adopted
                # dump's data buffer must be bytes — entry_list() raw
                # slices become FragmentIndex dict keys on the legacy
                # fallback path, and ndarray slices are unhashable.
                data = bytes(data)
            cols = ColumnarFragments(data, *rest)
            fragment_index = ColumnarFragmentIndex(
                cols, pre_dist, config.is_single_end()
            )
        else:
            fragment_index = _merge_columnar_shards(
                [payload[1] for payload in shard_payloads],
                pre_dist, config.is_single_end(),
                max_threads=config.threads,
            )
        num_lists = fragment_index.num_entries()
    else:
        fragment_index = FragmentIndex(pre_dist, config.is_single_end())
        for kind, (entries, frag_counts, unaligned), _ in shard_payloads:
            assert kind == "entries"
            shard_index = FragmentIndex(pre_dist, config.is_single_end())
            shard_index.entries = {
                (
                    entry[2][8:]  # native canonical key (raw minus count)
                    if entry[2] is not None
                    else tuple(ap.key() for ap in entry[0])
                ): entry
                for entry in entries
            }
            shard_index.frag_length_counts = frag_counts
            shard_index.unaligned_count = unaligned
            fragment_index.merge_from(shard_index)
        num_lists = len(fragment_index.entries)

    merge_s = _time.perf_counter() - merge_start
    log(
        f"Merged {num_workers} worker shards: "
        f"{num_lists} distinct alignment path lists"
    )
    # The parent needs its own finder: native-engine shards ship
    # pre-located entries whose probabilities are built from the raw
    # bytes by the native builder.  (Already built pre-fork above.)
    if finder is None:
        finder = build_finder(config, paths_index, pre_dist)
    infer_start = _time.perf_counter()
    stats = run_inference_phases(
        config, paths_index, fragment_index, pre_dist, log, finder=finder,
        info_future=info_future,
    )
    stats["fragment_pass_s"] = fragment_pass_s
    stats["fragment_scan_s"] = fragment_scan_s
    stats["merge_s"] = merge_s
    stats["inference_s"] = _time.perf_counter() - infer_start
    return stats


# ------------------------------------------------------- jax.distributed


def _allgather_payload(payload):
    """All-gather an arbitrary picklable payload across jax processes
    (lengths exchanged first, then the padded byte blobs)."""
    import pickle

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    blob = np.frombuffer(pickle.dumps(payload), dtype=np.uint8)
    lens = np.asarray(
        multihost_utils.process_allgather(jnp.asarray([blob.size], dtype=jnp.int64))
    ).reshape(-1)
    padded = np.zeros(int(lens.max()), dtype=np.uint8)
    padded[: blob.size] = blob
    blobs = np.asarray(multihost_utils.process_allgather(jnp.asarray(padded)))
    return [
        pickle.loads(blobs[i, : int(lens[i])].tobytes()) for i in range(lens.size)
    ]


def run_pipeline_distributed(
    config: PipelineConfig,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Dict:
    """True multi-process data-parallel pipeline over ``jax.distributed``
    (ICI/DCN collectives on real pods, Gloo on CPU):

    1. the fragment pass is sharded by process index,
    2. dedup shards are all-gathered and merged (every process then
       holds the identical fragment index — the histogram reduction the
       reference's indexing thread performs, distributed),
    3. inference runs on a strided subset of cluster ranks per process
       (rank-seeded RNG keeps draws identical to single-host),
    4. per-cluster results are all-gathered and process 0 writes the
       outputs — byte-identical to the single-host run.

    Call with `coordinator_address`/`num_processes`/`process_id` to
    initialize jax.distributed here, or initialize it before calling.
    """
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address, num_processes=num_processes, process_id=process_id
        )
    pid = jax.process_index()
    n = jax.process_count()

    log = lambda msg: print(f"[proc {pid}] {msg}", file=sys.stderr)  # noqa: E731

    graph, paths_index = load_inputs(config)
    pre_dist = resolve_pre_fragment_dist(config)
    finder = build_finder(config, paths_index, pre_dist)

    local = collect_fragments(config, finder, pre_dist, shard=pid, num_shards=n)
    payloads = _allgather_payload(
        (list(local.entries.values()), local.frag_length_counts, local.unaligned_count)
    )

    fragment_index = FragmentIndex(pre_dist, config.is_single_end())
    for entries, frag_counts, unaligned in payloads:
        shard_index = FragmentIndex(pre_dist, config.is_single_end())
        shard_index.entries = {
            (
                entry[2][8:]
                if entry[2] is not None
                else tuple(ap.key() for ap in entry[0])
            ): entry
            for entry in entries
        }
        shard_index.frag_length_counts = frag_counts
        shard_index.unaligned_count = unaligned
        fragment_index.merge_from(shard_index)
    log(
        f"merged {n} process shards: {len(fragment_index.entries)} distinct "
        f"alignment path lists"
    )

    prob_collector = [] if config.write_probs else None
    stats = run_inference_phases(
        config,
        paths_index,
        fragment_index,
        pre_dist,
        log,
        finder=finder,
        cluster_filter=lambda rank: rank % n == pid,
        skip_outputs=True,
        prob_collector=prob_collector,
    )

    gathered = _allgather_payload(stats["results"])
    merged = [result for results in gathered for result in results]
    merged.sort(key=lambda result: result.cluster_id)
    stats["results"] = merged

    if config.write_probs:
        # '-b' blocks are formatted on the owning process and written by
        # process 0 in cluster-rank order — the same order the in-process
        # writer produces (reference src/threaded_output_writer.cpp:40-95).
        gathered_blocks = _allgather_payload(prob_collector)
        if pid == 0:
            from ..io import writers

            prob_writer = writers.ProbabilityClusterWriter(
                config.output_prefix + "_probs", config.prob_precision
            )
            all_blocks = [b for blocks in gathered_blocks for b in blocks]
            all_blocks.sort(key=lambda item: item[0])
            for _, block in all_blocks:
                prob_writer.handle.write(block)
            prob_writer.close()

    if pid == 0:
        from ..pipeline import write_outputs

        if config.num_gibbs_samples > 0 and config.inference_model != "haplotypes":
            from ..io import writers

            gibbs_writer = writers.ReadCountGibbsSamplesWriter(
                config.output_prefix + "_gibbs", config.num_gibbs_samples
            )
            for result in merged:
                gibbs_writer.add_samples(result.cluster_id, result.estimates)
            gibbs_writer.finish(fragment_index.unaligned_count)
        write_outputs(config, merged, fragment_index.unaligned_count)
    return stats
