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
    import numpy as np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    hist, xedges, yedges = np.histogram2d(mu_d_opt, sigma_d_opt, bins=5)
    plt.imshow(hist, interpolation="nearest", origin="lower",
               extent=[xedges[0], xedges[-1], yedges[0], yedges[-1]],
               aspect="auto")
    plt.colorbar(label="Count")
    plt.xlabel("mu_d_opt")
    plt.ylabel("sigma_d_opt")
    plt.savefig(out_path)
    plt.close()
