"""Offline uncertainty quantification of a trained NeRF (the JAX package's
root uncertain.py; reference uncertain.py:251-471).

    python -m nerfsafetyvalidation_tpu_torch.uncertain <dataset dir> \\
        [--ff] [-O] [flags]

It reads envConfig.json's `uq_method` from the working directory, loads
the checkpoint `--ckpt` names under <workspace>/checkpoints through the
Trainer into the net the flags build (`--ff`: NeRFNetworkFF, both MLPs
through kernel K4), takes the test split's intrinsics and size, and runs
`uncertainty(...)` offline over every image of <dataset dir>/train: each
image's pose rendered whole through the staged render, then the Gaussian
UQ's (mu_d, sigma_d) or the Laplace UQ's MAP fit on every ray's point
(through K4 with `--ff`) and its (trace, rmv); the histogram heat map goes
to results/uncertainty_heatmap.png.

`main(argv, device)` runs on the CUDA card unless the caller passes
device='cpu'."""

import os

import torch

from .cli import apply_O_flag, build_parser
from .config import EnvConfig, network_config_from_opt
from .data.provider import NeRFDataset
from .data.rays import get_rays
from .models import make_network
from .models import renderer as R
from .train.trainer import Trainer
from .uq.orchestrator import uncertainty
from .utils.seeding import seed_everything


def main(argv=None, device="cuda"):
    """Returns `uncertainty`'s offline results dict."""
    opt = apply_O_flag(build_parser("uncertain").parse_args(argv),
                       "uncertain")
    env = EnvConfig.load("envConfig.json")
    print("Reading environment parameters from envConfig.json")

    seed_everything(opt.seed, device)
    net = make_network(network_config_from_opt(opt), None, device=device,
                       opt=opt, trainable=True)
    Trainer(opt, net, name="ngp", workspace=opt.workspace,
            use_checkpoint=opt.ckpt)
    for w in net.param_list():
        w.requires_grad_(False)
    dataset = NeRFDataset(opt, type="test", device=device)  # intrinsics

    def render_fn(rays_o, rays_d):
        return R.render(net, rays_o, rays_d, staged=True, bg_color=1.0,
                        perturb=False, num_steps=opt.num_steps,
                        upsample_steps=opt.upsample_steps,
                        max_ray_batch=opt.max_ray_batch)

    def get_rays_fn(pose):
        return get_rays(pose, dataset.intrinsics, dataset.H, dataset.W,
                        device=device)

    res = uncertainty(env.uq_method,
                      path_to_images=os.path.join(opt.path, "train"),
                      net=net, lr=opt.lr, render_fn=render_fn,
                      get_rays_fn=get_rays_fn, dataset_path=opt.path,
                      H=dataset.H, W=dataset.W)
    print("End of uncertainty computation".center(20, "."))
    return res


if __name__ == "__main__":
    main()
