"""The port's UQ evaluation metrics (nerfsafetyvalidation_tpu_torch/uq/
evaluation.py) against the JAX package's on the CPU: masked PSNR and SSIM
with and without a mask, the classification metrics, and LPIPS's
ImportError without the lpips package."""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.uq import evaluation as JE
from nerfsafetyvalidation_tpu_torch.uq import evaluation as TE

torch.set_num_threads(1)


def _images(seed=0, bs=2, h=24, w=20):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, (bs, 3, h, w)).astype(np.float32)
    preds = np.clip(target + rng.normal(0, 0.05, target.shape), 0, 1) \
        .astype(np.float32)
    mask = (rng.uniform(0, 1, (bs, 1, h, w)) < 0.6).astype(np.float32)
    return preds, target, mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_image_metrics_match_jax(metric, masked):
    """Per image, float32 sums in another order: PSNR within 1e-5 dB
    relative, SSIM (11x11 Gaussian window, zero padding) within 1e-5."""
    preds, target, mask = _images()
    m = mask if masked else None
    want = np.asarray(getattr(JE, f"masked_{metric}")(
        preds, target, None if m is None else jnp.asarray(m)))
    got = getattr(TE, f"masked_{metric}")(torch.from_numpy(preds), target,
                                          m).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    wrap = getattr(TE, f"calculate_{metric}")(preds, target, m).numpy()
    np.testing.assert_array_equal(wrap, got)


def test_ssim_window_is_jax_s():
    from nerfsafetyvalidation_tpu.train.metrics import _gaussian_kernel
    np.testing.assert_array_equal(TE._gaussian_kernel(), _gaussian_kernel())


@pytest.mark.parametrize("name", ["accuracy", "precision", "recall",
                                  "f1_score"])
def test_classification_metrics_match_jax(name):
    rng = np.random.default_rng(3)
    y_true = rng.integers(0, 2, 200)
    y_pred = rng.integers(0, 2, 200)
    want = getattr(JE, f"calculate_{name}")(y_true, y_pred)
    got = getattr(TE, f"calculate_{name}")(y_true, y_pred)
    assert got == want


@pytest.mark.skipif(importlib.util.find_spec("lpips") is not None,
                    reason="lpips is installed here: the ImportError path "
                           "does not run")
def test_lpips_needs_the_package():
    preds, target, mask = _images()
    for mod in (JE, TE):
        with pytest.raises(ImportError, match="lpips"):
            mod.masked_lpips(preds, target, mask)
