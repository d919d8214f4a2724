"""The port's image metrics (diffusioniqt_tpu_torch/metrics/image.py) and
the evaluation entry's scoring (diffusioniqt_tpu_torch/evaluate.py) against
the JAX package at fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.metrics import image as jmetrics
from diffusioniqt_tpu_torch.evaluate import evaluate
from diffusioniqt_tpu_torch.metrics import image as tmetrics

torch.set_num_threads(1)


def _pair(shape, seed):
    """A volume in [0, 1] and a noisy copy of it."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return a, b


# (shape, MS-SSIM kernel): 48^3 with kernel 3 keeps all five scales
# (48 // 16 >= 3); 24^3 with the default 11 keeps two; 8^3 shrinks the
# kernel to 7 and keeps one
@pytest.mark.parametrize("shape,kernel", [((1, 48, 48, 48, 1), 3), ((2, 24, 24, 24, 1), 11),
                                          ((1, 8, 8, 8, 2), 11)])
def test_metrics_match_jax(shape, kernel):
    a, b = _pair(shape, sum(shape))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    cases = [
        ("psnr", tmetrics.psnr(ta, tb, 2.0), jmetrics.psnr(ja, jb, 2.0)),
        ("PSNR", tmetrics.PSNR(ta, tb), jmetrics.PSNR(ja, jb)),
        ("SSIM", tmetrics.SSIM(ta, tb), jmetrics.SSIM(ja, jb)),
        ("ssim3d", tmetrics.ssim3d(ta, tb, kernel_size=min(kernel, 7)),
         jmetrics.ssim3d(ja, jb, kernel_size=min(kernel, 7))),
        ("MSSIM", tmetrics.MSSIM(ta, tb, kernel_size=kernel),
         jmetrics.MSSIM(ja, jb, kernel_size=kernel)),
    ]
    for name, got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5, err_msg=name)
    got_s, got_cs = tmetrics.ssim3d(ta, tb, return_contrast_sensitivity=True, kernel_size=3)
    want_s, want_cs = jmetrics.ssim3d(ja, jb, return_contrast_sensitivity=True, kernel_size=3)
    np.testing.assert_allclose([float(got_s), float(got_cs)], [float(want_s), float(want_cs)],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmetrics._avg_pool3d(ta).numpy(),
                               np.asarray(jmetrics._avg_pool3d(ja)), rtol=0, atol=1e-6)


def test_evaluate_matches_jax_composition():
    """Centre crop, MS-SSIM on jointly min-max-normalised volumes, PSNR
    (test_all.py:24-46), on z-score-like volumes."""
    rng = np.random.default_rng(3)
    gt = rng.standard_normal((40, 40, 40)).astype(np.float32)
    pred = (gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32)
    border = min(32, (40 - 1) // 3)
    got = evaluate(pred, gt, border=border, device="cpu")
    p5 = jnp.asarray(pred[border:-border, border:-border, border:-border])[None, ..., None]
    g5 = jnp.asarray(gt[border:-border, border:-border, border:-border])[None, ..., None]
    want_msssim = float(jmetrics.MSSIM((p5 - p5.min()) / (p5.max() - p5.min()),
                                       (g5 - g5.min()) / (g5.max() - g5.min())))
    want_psnr = float(jmetrics.PSNR(p5, g5))
    np.testing.assert_allclose([got["msssim"], got["psnr"]], [want_msssim, want_psnr],
                               rtol=0, atol=1e-5)
