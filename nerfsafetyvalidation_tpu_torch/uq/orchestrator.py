"""The UQ entry (nerfsafetyvalidation_tpu/uq/orchestrator.py; reference
uncertain.py `uncertainty()`, :20-247), for the Gaussian approximation:

  * online (`path_to_images` None): the (mu_d, sigma_d) of one render's
    extras, `rendered_output` a render dict or the (output, rays_o,
    rays_d) of Estimator.render_for_uncertainty (:77-91);
  * offline: every training image's render, its (mu_d, sigma_d), the
    absolutely certain (sigma_d <= 0) and uncertain (>= 3) ones counted
    apart and the rest histogrammed (:32-92).

The Bayesian-Laplace UQ raises (ROADMAP Queue 1 item 4)."""

import os

import torch

from .gaussian_approximation import GaussianApproximationDensityUncertainty
from .nerf_utils import create_heatmap, load_camera_params

LAPLACE = "Bayesian Laplace Approximation"


def uncertainty(method, path_to_images=None, rendered_output=None, net=None,
                params=None, lr=None, render_fn=None, get_rays_fn=None,
                dataset_path=None, H=800, W=800, laplace_max_points=None,
                laplace_fit_steps=1000):
    """The JAX package's arguments (`params` and the Laplace ones unused:
    the port's net holds its weights). Online Gaussian -> (mu_d_opt,
    sigma_d_opt); offline -> {'optimized_mu_d', 'optimized_sigma_d'}."""
    ac, au = 0, 0
    if method == "Gaussian Approximation":
        results = {"optimized_mu_d": [], "optimized_sigma_d": []}
        if path_to_images is None:
            out = rendered_output[0] if isinstance(rendered_output, tuple) \
                else rendered_output
            ga = GaussianApproximationDensityUncertainty(
                out["rgbs"], out["sigmas"], out["image"])
            mu_d_opt, sigma_d_opt = ga.optimize()
            print(f"mu_d_opt = {mu_d_opt}, sigma_d_opt = {sigma_d_opt}")
            return mu_d_opt, sigma_d_opt
        for i, image_name in enumerate(os.listdir(path_to_images)):
            rel = f"./train/{image_name}"
            cam = torch.tensor([load_camera_params(rel, dataset_path)],
                               dtype=torch.float32)
            rays = get_rays_fn(cam)
            with torch.no_grad():
                output = render_fn(rays["rays_o"].reshape(1, -1, 3),
                                   rays["rays_d"].reshape(1, -1, 3))
            ga = GaussianApproximationDensityUncertainty(
                output["rgbs"], output["sigmas"], output["image"])
            mu_d_opt, sigma_d_opt = ga.optimize()
            if sigma_d_opt <= 0:
                ac += 1
            elif sigma_d_opt >= 3:
                au += 1
            else:
                results["optimized_mu_d"].append(mu_d_opt)
                results["optimized_sigma_d"].append(sigma_d_opt)
            print(f"Image #{i} ({image_name}): mu_d_opt = {mu_d_opt}, "
                  f"sigma_d_opt = {sigma_d_opt}")
        if results["optimized_mu_d"]:
            create_heatmap(results["optimized_mu_d"],
                           results["optimized_sigma_d"])
        return results
    if method == LAPLACE:
        raise NotImplementedError(
            "the Bayesian-Laplace UQ (uq/bayesian_laplace.py, "
            "get_sigma_net_flat and the MAP fit) is not ported yet: ROADMAP "
            "Queue 1 item 4")
    raise ValueError(f"Unrecognized uncertainty quantification method "
                     f"{method}")
