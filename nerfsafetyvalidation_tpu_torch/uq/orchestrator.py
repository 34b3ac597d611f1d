"""The UQ entry (nerfsafetyvalidation_tpu/uq/orchestrator.py; reference
uncertain.py `uncertainty()`, :20-247).

The Gaussian approximation:
  * online (`path_to_images` None): the (mu_d, sigma_d) of one render's
    extras, `rendered_output` a render dict or the (output, rays_o,
    rays_d) of Estimator.render_for_uncertainty (:77-91);
  * offline: every training image's render, its (mu_d, sigma_d), the
    absolutely certain (sigma_d <= 0) and uncertain (>= 3) ones counted
    apart and the rest histogrammed (:32-92).

The Bayesian Laplace approximation (uq/bayesian_laplace.py) on the points
X = rays_o + rays_d of every ray against the render's aggregated density:
  * online: `rendered_output` the (output, rays_o, rays_d) tuple ->
    (trace / n, sqrt(mean(diag)) / n) of the posterior covariance (:180-231);
  * offline: every training image's render, its (trace, rmv), histogrammed
    (:98-179).
The net's weights are never changed (the fit keeps its own sigma net), so
the reference's restore of them after the online fit has nothing to do."""

import os

import torch

from .bayesian_laplace import BayesianLaplace
from .gaussian_approximation import GaussianApproximationDensityUncertainty
from .nerf_utils import create_heatmap, load_camera_params

LAPLACE = "Bayesian Laplace Approximation"


def _camera(image_name, dataset_path):
    return torch.tensor([load_camera_params(f"./train/{image_name}",
                                            dataset_path)],
                        dtype=torch.float32)


def _laplace(net, lr, rays_o, rays_d, d, H, W, max_points, fit_steps):
    """One Laplace fit on a render's rays and aggregated density ->
    (trace, rmv)."""
    rays_o = rays_o.reshape(H, W, -1)
    rays_d = rays_d.reshape(H, W, -1)
    X = rays_o[..., None, :] + rays_d[..., None, :]
    bl = BayesianLaplace(net, 0.0, 1.0, lr, max_points=max_points,
                         fit_steps=fit_steps)
    bl.fit(X, d)
    return _posterior_stats(bl)


def _posterior_stats(bl):
    """(trace / n, sqrt(mean(diag)) / n) of the posterior covariance, its
    diagonal first clamped at 0 in place (the JAX version mutates the
    fitted object's covariance so)."""
    diag = bl.get_posterior_cov().diagonal()
    diag.clamp_(min=0)
    n = diag.shape[0]
    return float(diag.sum() / n), float(torch.sqrt(diag.mean()) / n)


def uncertainty(method, path_to_images=None, rendered_output=None, net=None,
                params=None, lr=None, render_fn=None, get_rays_fn=None,
                dataset_path=None, H=800, W=800, laplace_max_points=None,
                laplace_fit_steps=1000):
    """The JAX package's arguments (`params` unused: the port's net holds
    its weights). Online Gaussian -> (mu_d_opt, sigma_d_opt), Laplace ->
    (trace, rmv); offline -> {'optimized_mu_d', 'optimized_sigma_d'} or
    {'trace', 'rmv'}. Each Laplace fit draws from a generator of its own
    seeded 0, as each JAX fit starts from PRNGKey(0)."""
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
            rays = get_rays_fn(_camera(image_name, dataset_path))
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
        args = dict(H=H, W=W, max_points=laplace_max_points,
                    fit_steps=laplace_fit_steps)
        if path_to_images is None:
            out, rays_o, rays_d = rendered_output
            trace, rmv = _laplace(net, lr, rays_o, rays_d,
                                  out["aggregated_density"], **args)
            print(f"trace = {trace}, rmv = {rmv}")
            return trace, rmv
        results = {"trace": [], "rmv": []}
        for i, image_name in enumerate(os.listdir(path_to_images)):
            rays = get_rays_fn(_camera(image_name, dataset_path))
            with torch.no_grad():
                output = render_fn(rays["rays_o"].reshape(1, -1, 3),
                                   rays["rays_d"].reshape(1, -1, 3))
            trace, rmv = _laplace(net, lr, rays["rays_o"], rays["rays_d"],
                                  output["aggregated_density"], **args)
            results["trace"].append(trace)
            results["rmv"].append(rmv)
            print(f"Image #{i} ({image_name}): trace = {trace}, rmv = {rmv}")
        if results["trace"]:
            create_heatmap(results["trace"], results["rmv"])
        return results
    raise ValueError(f"Unrecognized uncertainty quantification method "
                     f"{method}")
