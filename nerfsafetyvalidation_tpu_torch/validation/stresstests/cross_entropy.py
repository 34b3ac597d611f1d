"""The cross-entropy method's weighted moments (nerfsafetyvalidation_tpu/
validation/stresstests/cross_entropy.py `_weighted_mean_cov`), numpy. The
sequential `CrossEntropyMethod` is not ported yet."""

import numpy as np


def _weighted_mean_cov(samples, weights):
    """torch.cov(samples.T, aweights=w) and the weighted mean, float64.
    samples: [M, D]; weights: [M]. The normalisation w.sum() - (w^2).sum()
    / w.sum() is floored at 1e-12, so one elite holding all the weight
    gives a covariance of ~0 instead of NaN."""
    w = np.asarray(weights, dtype=np.float64)
    x = np.asarray(samples, dtype=np.float64)
    wsum = w.sum()
    mean = (w[:, None] * x).sum(0) / wsum
    diff = x - mean
    denom = max(wsum - (w ** 2).sum() / wsum, 1e-12)
    return mean, (w[:, None] * diff).T @ diff / denom
