"""UQ evaluation metrics (nerfsafetyvalidation_tpu/uq/evaluation.py;
reference uncertainty/evaluation/{metrics,image_metrics}.py): the
classification metrics (accuracy, precision, recall, F1 on numpy arrays,
metrics.py:4-20) and the masked image metrics (PSNR, SSIM, LPIPS,
image_metrics.py:79-169). Images are [bs, 3, H, W] in [0, 1] and masks
[bs, 1, H, W], tensors or arrays; each image metric returns [bs]. SSIM
uses the 11x11 Gaussian window (sigma 1.5) and the constants of the JAX
package's train/metrics.py; LPIPS needs the optional lpips package and
raises ImportError without it."""

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------ classification (:4-20)
def calculate_accuracy(y_true, y_pred):
    return np.mean(np.asarray(y_true) == np.asarray(y_pred))


def calculate_precision(y_true, y_pred):
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = np.sum((y_true == 1) & (y_pred == 1))
    fp = np.sum((y_true == 0) & (y_pred == 1))
    return tp / (tp + fp)


def calculate_recall(y_true, y_pred):
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = np.sum((y_true == 1) & (y_pred == 1))
    fn = np.sum((y_true == 1) & (y_pred == 0))
    return tp / (tp + fn)


def calculate_f1_score(y_true, y_pred):
    precision = calculate_precision(y_true, y_pred)
    recall = calculate_recall(y_true, y_pred)
    return 2 * (precision * recall) / (precision + recall)


# ------------------------------------------------------- image metrics (:79+)
def _t(x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32)


def masked_psnr(preds, target, mask=None):
    """Per-image PSNR over the mask's pixels (image_metrics.py:79-105)."""
    preds, target = _t(preds), _t(target)
    bs = preds.shape[0]
    hw = preds.shape[2] * preds.shape[3]
    num = (preds.reshape(bs, 3, hw) - target.reshape(bs, 3, hw)) ** 2
    if mask is None:
        den = hw
    else:
        m = _t(mask).to(preds.device).reshape(bs, 1, hw)
        num = num * m
        den = m.sum(-1)
    mse = num.sum(-1) / den
    return (10 * torch.log10(1.0 / mse)).mean(-1)


def _gaussian_kernel(size=11, sigma=1.5):
    """The JAX package's SSIM window (train/metrics.py:90-94)."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_image(preds, target):
    """The per-pixel SSIM map [bs, H, W], averaged over the channels (the
    window zero-padded at the borders, as XLA's "SAME")."""
    k = torch.as_tensor(_gaussian_kernel(), dtype=torch.float32,
                        device=preds.device)[None, None]

    def filt(x):
        bs, c, h, w = x.shape
        return F.conv2d(x.reshape(bs * c, 1, h, w), k,
                        padding=k.shape[-1] // 2).reshape(bs, c, h, w)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu0, mu1 = filt(preds), filt(target)
    s00 = filt(preds * preds) - mu0 ** 2
    s11 = filt(target * target) - mu1 ** 2
    s01 = filt(preds * target) - mu0 * mu1
    ssim = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / \
        ((mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
    return ssim.mean(1)


def masked_ssim(preds, target, mask=None):
    """Per-image SSIM, mask-weighted (image_metrics.py:107-136)."""
    preds, target = _t(preds), _t(target)
    bs = preds.shape[0]
    ssim_image = _ssim_image(preds, target).reshape(bs, -1)
    if mask is None:
        return ssim_image.mean(1)
    m = _t(mask).to(preds.device).reshape(bs, -1)
    den = m.sum(-1, keepdim=True)
    return (ssim_image * m / den).sum(-1)


def masked_lpips(preds, target, mask=None):
    """image_metrics.py:138-169; needs the optional lpips package."""
    try:
        import lpips
    except ImportError as e:
        raise ImportError("masked_lpips requires the 'lpips' package") from e
    fn = lpips.LPIPS(net="alex", spatial=True).eval()
    with torch.no_grad():
        lp = fn(_t(target).cpu() * 2 - 1, _t(preds).cpu() * 2 - 1)
    lp = lp.mean(1).numpy()  # [bs, H, W]
    bs = lp.shape[0]
    if mask is None:
        return lp.reshape(bs, -1).mean(1)
    m = np.asarray(_t(mask).cpu()).reshape(bs, -1)
    den = m.sum(-1, keepdims=True)
    return (lp.reshape(bs, -1) * m / den).sum(-1)


# reference metrics.py:22-30 wrappers
def calculate_psnr(preds, target, mask=None):
    return masked_psnr(preds, target, mask)


def calculate_ssim(preds, target, mask=None):
    return masked_ssim(preds, target, mask)


def calculate_lpips(preds, target, mask=None):
    return masked_lpips(preds, target, mask)
