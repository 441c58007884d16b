"""Measured host<->device link policy.

The hybrid EM/posterior routing decides which clusters run on the
accelerator and which stay on the host C++ kernels.  Round 2 used a
hard-coded area cutoff tuned for one workload on one link; this module
replaces that guess with numbers measured once per process:

* dispatch latency — one tiny jitted call, synced;
* host->device bandwidth — one ~4 MB transfer, synced.

Both are cheap (<0.2 s after backend init, amortised across a run) and
cached for the process.  Everything is env-overridable so benchmarks and
tests can pin behavior:

  RPVG_TPU_LINK_H2D_BPS      bytes/s (skip the probe)
  RPVG_TPU_LINK_DISPATCH_S   seconds (skip the probe)
  RPVG_TPU_HOST_EM_NS_AREA   host nested-inference ns per dense matrix
                             element (default 150, from profiling the
                             native fused kernel at bench scale)
"""

from __future__ import annotations

import os
import time
from typing import Optional
from .. import backend

_CACHE: Optional[dict] = None

# Host cost of native fused nested inference per dense matrix element,
# used to size the host work window transfers must hide under.  A
# planning constant: not measured on the H100's host.
DEFAULT_HOST_EM_NS_PER_AREA = 150.0


def probe_link(force: bool = False) -> Optional[dict]:
    """Measure the accelerator link; None on CPU-only backends.

    Returns {"dispatch_s", "h2d_bps", "host_em_ns_per_area"}."""
    global _CACHE
    if _CACHE is not None and not force:
        return _CACHE or None

    import jax

    if not backend.device_enabled():
        _CACHE = {}
        return None

    env_bps = os.environ.get("RPVG_TPU_LINK_H2D_BPS")
    env_disp = os.environ.get("RPVG_TPU_LINK_DISPATCH_S")
    if env_bps and env_disp:
        _CACHE = {
            "dispatch_s": float(env_disp),
            "h2d_bps": float(env_bps),
            "host_em_ns_per_area": float(
                os.environ.get("RPVG_TPU_HOST_EM_NS_AREA", DEFAULT_HOST_EM_NS_PER_AREA)
            ),
        }
        return _CACHE

    import jax.numpy as jnp
    import numpy as np

    fn = jax.jit(lambda x: x * 2.0)
    tiny = np.ones(8, dtype=np.float32)
    # Warm (compile + first transfer outside the measurement).
    np.asarray(fn(tiny))
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        np.asarray(fn(tiny))
    dispatch_s = (time.perf_counter() - t0) / reps

    if env_bps:
        h2d_bps = float(env_bps)
    else:
        blob = np.ones(1 << 20, dtype=np.float32)  # 4 MB
        jax.device_put(blob).block_until_ready()  # warm allocator
        t0 = time.perf_counter()
        jax.device_put(blob).block_until_ready()
        h2d_bps = blob.nbytes / max(1e-9, time.perf_counter() - t0)

    _CACHE = {
        "dispatch_s": float(env_disp) if env_disp else dispatch_s,
        "h2d_bps": h2d_bps,
        "host_em_ns_per_area": float(
            os.environ.get("RPVG_TPU_HOST_EM_NS_AREA", DEFAULT_HOST_EM_NS_PER_AREA)
        ),
    }
    return _CACHE


def select_device_slots(areas, force_env: str = "RPVG_TPU_DEVICE_SLOT_AREA"):
    """Greedy measured-policy split of a cluster population.

    `areas`: dense matrix elements per slot.  Routes the largest slots
    to the device while their (f32) transfer time still fits inside the
    host-compute window of the remaining slots — the transfers ride
    under the native kernel's concurrent work, so the device share is
    pure saving.  Returns a sorted list of routed slot positions
    (possibly empty).

    RPVG_TPU_DEVICE_SLOT_AREA=<n> overrides with a plain area cutoff
    (route every slot with area >= n; 0 disables routing)."""
    import numpy as np

    areas = np.asarray(areas, dtype=np.int64)
    env = os.environ.get(force_env)
    if env is not None:
        cutoff = int(env)
        if cutoff <= 0:
            return []
        return np.flatnonzero(areas >= cutoff).tolist()

    link = probe_link()
    if not link:
        return []
    host_ns = link["host_em_ns_per_area"]
    bps = link["h2d_bps"]
    order = np.argsort(-areas)
    total_area = int(areas.sum())
    routed_area = 0
    routed_bytes = 0.0
    routed = []
    # Fixed per-run device overhead must pay for itself: require the
    # routed share to be worth at least ~4 dispatches of latency.
    min_win_s = 4.0 * link["dispatch_s"]
    for pos in order:
        a = int(areas[pos])
        if a == 0:
            break
        nbytes = 4.0 * a + 512.0  # f32 payload + per-slot metadata
        transfer_s = (routed_bytes + nbytes) / bps
        host_window_s = host_ns * 1e-9 * (total_area - routed_area - a)
        if transfer_s > host_window_s:
            break
        routed.append(int(pos))
        routed_area += a
        routed_bytes += nbytes
    if routed_area * host_ns * 1e-9 < min_win_s:
        return []
    return sorted(routed)
