"""Train and test a NeRF: the port of the JAX package's root script
main_nerf.py (reference main_nerf.py:8-142), with the same flags.

    python -m nerfsafetyvalidation_tpu_torch.main_nerf <dataset dir> [flags]

`-O` expands to bf16 compute, the occupancy-marched training render and
preloaded images. The net is the JAX package's dispatch on the flags
(`models.make_network`): `--tcnn` builds `NeRFNetworkTCNN` (biased MLPs,
plain chains), `--ff` `NeRFNetworkFF` (bfloat16, its MLPs through kernel
K4, with or without `-O`; without it, training renders 512 uniform
samples a ray), else `NeRFNetwork`; `--encoding hashgrid|tiledgrid|None`
picks the position encoder, `--bg_radius R > 0` adds the background net,
`--error_map` draws the training rays by the per-view error map. It
builds the net from a seed, the dataset's loaders (images of another size
resized as cv2's INTER_AREA resizes them) and the trainer (EMA 0.95, an
evaluation every 50 epochs), trains whole epochs up to `--iters` steps,
keeping its checkpoints under `<workspace>/checkpoints`, then evaluates
the test split and writes its frames under `<workspace>/results` (mp4s
where imageio has a backend, else PNGs). With `--test` it loads the
checkpoint `--ckpt` names, evaluates, writes the frames in
`--render_mode` staged, fast, guided or scout, and writes the density's
iso-surface at 256^3, threshold 10, as `<workspace>/meshes/ngp_<epoch>.ply`.

`main(argv, device)` runs on the CUDA card unless the caller passes
device='cpu'; `on_epoch(trainer)`, where given, runs after every training
epoch."""

import numpy as np

from .cli import apply_O_flag, build_parser
from .config import network_config_from_opt
from .data.provider import NeRFDataset
from .models import make_network
from .train.trainer import Trainer
from .utils.seeding import seed_everything

# `--test`'s mesh: the grid's side and the density's iso-value
# (main_nerf.py:38 of the root script)
MESH_RESOLUTION = 256
MESH_THRESHOLD = 10


def main(argv=None, device="cuda", on_epoch=None):
    """Returns the trainer."""
    opt = apply_O_flag(build_parser("train").parse_args(argv), "train")
    gen = seed_everything(opt.seed, device)
    net = make_network(network_config_from_opt(opt), None, device=device,
                       opt=opt, trainable=True, generator=gen)

    def dataset(type, **kw):
        return NeRFDataset(opt, type=type, device=device, **kw)

    if opt.test:
        trainer = Trainer(opt, net, name="ngp", workspace=opt.workspace,
                          use_checkpoint=opt.ckpt)
        test_loader = dataset("test").dataloader()
        if test_loader.has_gt:
            trainer.evaluate(test_loader)
        trainer.test(test_loader, write_video=True)
        trainer.save_mesh(resolution=MESH_RESOLUTION,
                          threshold=MESH_THRESHOLD)
        return trainer

    train_loader = dataset("train").dataloader()
    valid_loader = dataset("val", downscale=1).dataloader()
    max_epoch = int(np.ceil(opt.iters / len(train_loader)))
    trainer = Trainer(opt, net, name="ngp", workspace=opt.workspace,
                      use_checkpoint=opt.ckpt, ema_decay=0.95,
                      eval_interval=50)
    trainer.train(train_loader, valid_loader, max_epoch, on_epoch=on_epoch)

    # also test at the end (main_nerf.py:131-140)
    test_loader = dataset("test").dataloader()
    if test_loader.has_gt:
        trainer.evaluate(test_loader)
    trainer.test(test_loader, write_video=True)
    return trainer


if __name__ == "__main__":
    main()
