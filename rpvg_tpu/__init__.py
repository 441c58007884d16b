"""rpvg_tpu — pantranscriptome quantification engine in JAX.

A from-scratch reimplementation of the capabilities of rpvg (Sibbesen,
Eizenga et al., Nature Methods 20:239-247, 2023): inference of
haplotype-specific transcript posteriors and expression abundances from
pangenome-graph RNA-seq alignments.

Architecture (two halves split at the read x path likelihood matrix):

* Host front half: streaming alignment parsing, haplotype path index
  (GBWT-equivalent positional occurrence index), alignment->path
  projection, fragment dedup and clustering.  Irregular, pointer-chasing
  work; runs on CPU (numpy-vectorised + optional C++ kernels).
* Device back half (JAX/XLA): everything downstream of the probability
  matrix — batched EM abundance estimation, haplotype group posteriors
  (marginal/full/diploid-dense/Gibbs), Gibbs read-count sampling and the
  TPM normalisation reduction — expressed as padded, bucketed batch
  kernels vmapped over a device mesh.

Numeric contract follows the reference implementation
(/root/reference/src/utils.hpp:83-84,503-512 and
/root/reference/src/main.cpp:380-419); float64 is used on the host and
on the CPU backend, float32 in device buffers on an accelerator
(rpvg_tpu.backend.device_dtype).
"""

import os

# Keep large host buffers on the reusable heap (this class of host
# serves fresh mmap pages extremely slowly); see hostalloc.py.
from .hostalloc import tune_glibc_allocator as _tune_glibc_allocator

_tune_glibc_allocator()

# The reference engine computes in float64 throughout.  Enable x64 so CPU
# test runs are bit-comparable; device kernels request float32 explicitly.
if os.environ.get("RPVG_TPU_DISABLE_X64", "0") != "1":
    import jax

    jax.config.update("jax_enable_x64", True)


def _compile_cache_dir() -> str:
    """Fixed in-checkout cache root, scoped by host CPU features: XLA:CPU
    AOT results compiled for another microarchitecture can SIGILL."""
    import hashlib
    import platform

    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as cpuinfo:
            for line in cpuinfo:
                if line.startswith("flags"):
                    tag += hashlib.sha1(line.encode()).hexdigest()[:8]
                    break
    except OSError:
        pass
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache", tag)


# Persistent XLA compilation cache: the engine's kernel population is a
# small set of padded bucket shapes, so warm runs skip compilation.
# JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise
# the cache lives inside the checkout.  RPVG_TPU_NO_COMPILE_CACHE=1 opts
# out.
if os.environ.get("RPVG_TPU_NO_COMPILE_CACHE", "0") != "1":
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

__version__ = "0.1.0"
