"""Evaluation metrics (nerfsafetyvalidation_tpu/train/metrics.py:
`PSNRMeter`)."""

import numpy as np


class PSNRMeter:
    """Mean PSNR over the updates: -10 log10(MSE) of each (preds, truths)
    pair, arrays or tensors."""

    def __init__(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        """Adds the PSNR of one pair, and returns it."""
        preds, truths = (np.asarray(a.detach().cpu() if hasattr(a, "detach")
                                    else a) for a in (preds, truths))
        psnr = float(-10.0 * np.log10(np.mean((preds - truths) ** 2)))
        self.V += psnr
        self.N += 1
        return psnr

    def clear(self):
        self.V = 0.0
        self.N = 0

    def measure(self):
        return self.V / max(self.N, 1)

    def report(self):
        return f"PSNR = {self.measure():.6f}"
