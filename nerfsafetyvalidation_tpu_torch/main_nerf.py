"""Train and test a NeRF: the port of the JAX package's root script
main_nerf.py (reference main_nerf.py:8-142), with the same flags.

    python -m nerfsafetyvalidation_tpu_torch.main_nerf <dataset dir> [flags]

`-O` expands to bf16 compute, the occupancy-marched training render and
preloaded images. The net is the JAX package's dispatch on the flags
(`models.make_network`): `--ff` builds `NeRFNetworkFF`, which computes in
bfloat16 with both MLPs through kernel K4 with or without `-O` (without
it, training renders 512 uniform samples a ray); `--tcnn` raises, as its
net is not ported. It builds the net from a
seed, the dataset's loaders and the trainer (EMA 0.95, an evaluation every
50 epochs), trains whole epochs up to `--iters` steps, keeping its
checkpoints under `<workspace>/checkpoints`, then evaluates the test split
and writes its frames as PNGs under `<workspace>/results`. With `--test` it
loads the checkpoint `--ckpt` names, evaluates and writes the frames; the
mesh export is not ported yet, and it says so.

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
        trainer.test(test_loader)
        print("[INFO] mesh export (save_mesh) is not ported yet: no mesh "
              "written")
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
    trainer.test(test_loader)
    return trainer


if __name__ == "__main__":
    main()
