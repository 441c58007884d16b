"""The one accelerator decision.

Inference (``rpvg_tpu/infer/``) has two engines for every job: the host
C++ kernels in float64, and the padded, bucketed JAX kernels.  Which one
runs is decided here and nowhere else:

* :func:`platform` — the JAX platform of this process (cached).  A
  platform that fails to initialise raises :class:`BackendUnavailable`;
  there is no fallback to the CPU.
* :func:`device_enabled` — whether the device path is on: true for any
  platform other than ``cpu``.
* :func:`device_dtype` — the float type device buffers are padded in.
* :data:`MATMUL_PRECISION` — the precision every device contraction
  asks for, so a GPU never computes them in TF32.
* :func:`fixed_order_sum` — the sum every batched device kernel uses, so
  a cluster's result is the same bits whatever batch it shares and
  however many devices the batch is split over.

:data:`WORK` counts clusters and tasks per engine (``"em.device"``,
``"em.host"``, ...), so a run can show which engine did its work.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_LOCK = threading.Lock()
_PLATFORM: Optional[str] = None

WORK: Counter = Counter()


class BackendUnavailable(RuntimeError):
    """The requested JAX platform could not be initialised."""


MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def fixed_order_sum(x, axis: int):
    """Sum `x` over `axis` by halving: zero-pad the axis to a power of
    two, then add its upper half onto its lower half until one element
    is left.

    The order of additions is fixed by the program, not by the
    compiler: XLA's GPU reductions and cuBLAS pick their summation
    order per operand shape, so a cluster summed in a batch of B and in
    a batch of B/4 (one device's share of a 4-way data mesh) can differ
    in the last bits.  Each step here is an elementwise add, whose
    result does not depend on the shape around it, and zero padding of
    the summed axis to a larger power of two does not change the sum."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    width = 1
    while width < n:
        width *= 2
    if width != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - n)])
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def platform() -> str:
    """``jax.default_backend()``, resolved once per process."""
    global _PLATFORM
    if _PLATFORM is None:
        with _LOCK:
            if _PLATFORM is None:
                try:
                    _PLATFORM = jax.default_backend()
                except (RuntimeError, AssertionError) as exc:
                    # JAX raises AssertionError for a platform name no
                    # installed plugin provides.
                    detail = (str(exc).splitlines() or [""])[0]
                    raise BackendUnavailable(
                        "JAX platform unavailable: "
                        + (detail or f"no backend for {jax.config.jax_platforms!r}")
                    ) from exc
    return _PLATFORM


def device_enabled() -> bool:
    """True when inference should run its device kernels."""
    return platform() != "cpu"


def device_dtype():
    """float32 on an accelerator (the kernels are bound by memory and
    latency, and float64 halves the GPU's vector rate), float64 on the
    CPU, where the padded kernels are the bitwise reference of the host
    C++ kernels."""
    return np.float32 if device_enabled() else np.float64


def count_work(kind: str, device: bool, n: int) -> None:
    """Record that `n` clusters or tasks of `kind` ran on the device or
    on the host."""
    if n:
        WORK[f"{kind}.{'device' if device else 'host'}"] += int(n)


def initialised_platform() -> Optional[str]:
    """The platform this process has already started, or None if no JAX
    backend is up yet (checking starts none)."""
    from jax._src import xla_bridge

    return jax.default_backend() if xla_bridge.backends_are_initialized() else None


def pin_platform(name: str) -> None:
    """Pin this process to JAX platform `name` without starting it: the
    first :func:`platform` call starts it.  ``gpu`` means an NVIDIA GPU:
    JAX expands that alias to ``cuda,rocm`` and fails unless both
    plugins are installed."""
    global _PLATFORM
    jax.config.update("jax_platforms", "cuda" if name == "gpu" else name)
    with _LOCK:
        _PLATFORM = None


def require_platform(name: str) -> str:
    """Pin this process to JAX platform `name` and initialise it now;
    raises :class:`BackendUnavailable` if it cannot start."""
    pin_platform(name)
    return platform()


def reset_for_tests() -> None:
    """Forget the cached platform (tests only)."""
    global _PLATFORM
    with _LOCK:
        _PLATFORM = None
