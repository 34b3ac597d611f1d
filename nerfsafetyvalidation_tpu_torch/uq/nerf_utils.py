"""UQ helpers (nerfsafetyvalidation_tpu/uq/nerf_utils.py; reference
uncertainty/quantification/utils/nerfUtils.py): a training image's camera
from transforms_train.json, and the (mu_d, sigma_d) heat map."""

import json
import os


def load_camera_params(image_name, dataset_path):
    image_name = os.path.splitext(image_name)[0]
    with open(os.path.join(dataset_path, "transforms_train.json")) as f:
        transform = json.load(f)
    for frame in transform["frames"]:
        if frame["file_path"] == image_name:
            return frame["transform_matrix"]
    raise ValueError(f"Camera parameters for image {image_name} not found.")


def create_heatmap(mu_d_opt, sigma_d_opt,
                   out_path="results/uncertainty_heatmap.png"):
    """The 5 x 5 histogram of the (mu_d, sigma_d) pairs (or (trace, rmv)),
    numpy's histogram2d as the JAX package's, written as a PNG through the
    port's own codec (data/png.py): the card's machine has no matplotlib.
    The counts scaled to 0-255, mu_d along x, sigma_d up (the JAX figure's
    origin="lower"), each bin 64 x 64 pixels; the JAX figure's axes and
    colour bar are not drawn."""
    import numpy as np
    from ..data.png import write_png
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    hist = np.histogram2d(mu_d_opt, sigma_d_opt, bins=5)[0]
    # imshow(hist) draws hist[i, j] at row i, column j; origin lower
    # puts row 0 at the bottom
    img = np.round(255.0 * hist / max(hist.max(), 1.0)).astype(np.uint8)
    img = np.repeat(np.repeat(img[::-1], 64, axis=0), 64, axis=1)
    write_png(out_path, np.stack([img] * 3, axis=-1))
