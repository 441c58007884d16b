"""Card-only checks of the device path (pytest -m gpu; they skip where
JAX finds no GPU).  chip_smoke.py runs them on the card."""

import numpy as np
import pytest

from rpvg_tpu import backend

pytestmark = pytest.mark.gpu


def test_gpu_turns_the_device_path_on(gpu_device):
    backend.reset_for_tests()
    assert backend.platform() == "gpu"
    assert backend.device_enabled() and backend.device_dtype() is np.float32
    assert gpu_device.memory_stats()["bytes_limit"] > 0


def test_em_on_the_card_matches_native(gpu_device, monkeypatch):
    from rpvg_tpu.infer import batching

    monkeypatch.setenv("RPVG_TPU_HYBRID_EM_AREA", "0")
    rng = np.random.default_rng(4)
    inputs = []
    for _ in range(40):
        R, C = int(rng.integers(8, 600)), int(rng.integers(2, 40))
        probs = rng.random((R, C)) ** 3
        probs /= probs.sum(axis=1, keepdims=True)
        inputs.append((probs, rng.integers(1, 9, R).astype(np.float64)))
    dev = batching.run_batched_em(inputs, 200, 0.0)
    host = batching.run_native_em(inputs, 200, 0.0)
    for (dc, dn), (hc, hn), (_, counts) in zip(dev, host, inputs):
        total = counts.sum()
        np.testing.assert_allclose(
            np.append(dc, dn) / total, np.append(hc, hn) / total, rtol=1e-4, atol=1e-6
        )


def test_pair_scores_on_the_card_match_native(gpu_device):
    from rpvg_tpu.infer import posteriors

    rng = np.random.default_rng(6)
    inputs = []
    for _ in range(20):
        R, P = int(rng.integers(8, 300)), int(rng.integers(2, 40))
        inputs.append(
            (rng.random((R, P)) ** 2, rng.random(R) * 1e-3,
             rng.integers(1, 6, R).astype(np.float64), [1] * P)
        )
    scores = posteriors.gather_pair_scores(
        posteriors.dispatch_pair_scores(inputs, range(len(inputs))), inputs
    )
    native = posteriors._native_pair_scores(inputs)
    for idx, matrix in scores:
        np.testing.assert_allclose(matrix, native[idx], rtol=1e-5)



@pytest.mark.parametrize(
    "kernel, sizes",
    [
        ("em", (64, 256, 64)),
        ("pair_scores_batched", (32, 256, 32)),
        ("group_scores", (64, 256, 16)),
        ("readcount_gibbs", (16, 64, 16)),
    ],
)
def test_batched_kernels_are_batch_size_invariant_on_the_card(gpu_device, kernel, sizes):
    """A quarter of a batch, as one of four cards holds it under the data
    mesh, gives each of its clusters the same bits as the whole batch."""
    import jax

    from test_backend import _batched_kernel

    B, R, P = sizes
    fn, args = _batched_kernel(kernel, B, R, P)
    full = jax.tree.leaves(fn(*args))
    part = jax.tree.leaves(fn(*[a[B // 4 : B // 2] for a in args]))
    for whole, piece in zip(full, part):
        if np.ndim(whole) and np.shape(whole)[0] == B:
            np.testing.assert_array_equal(np.asarray(whole)[B // 4 : B // 2], np.asarray(piece))
