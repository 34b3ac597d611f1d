"""The training loop of the port (nerfsafetyvalidation_tpu/train/
trainer.py, `Trainer`), for occupancy-marched training (cfg.grid_ray).

One iteration: the occupancy refresh on its schedule (every
`update_extra_interval` steps; full probes while the grid still carves,
then one of 4 morton-strided blocks in rotation, each through a freshly
folded table), then one step: the pixel-wise random background for RGBA
targets, the marched render `run_grid` with the phased sample budget, the
MSE, the backward, the Adam update, the learning-rate decay and, where
`ema_decay` is set, the per-step EMA. Evaluation (`eval_step`,
`evaluate_one_epoch`, `evaluate`) renders whole views through the staged
uniform-sampling render, on the EMA parameters where there are some, and
scores them with the PSNR meter; it writes no images.

The JAX trainer jits the step; here it runs eagerly. Its random draws
(background, march jitter, refresh jitter) come from a torch.Generator
seeded `opt.seed + 1`, or are handed in, as the tests hand in the JAX
trainer's own draws. Not ported: the uniform-sampling render
(grid_ray=False), the error map, CLIP guidance, the fused multi-step scan,
checkpoints, `test` and `fold_warmup_scale`.
"""

import torch

from ..data.rays import srgb_to_linear
from ..models import make_network
from ..models.renderer import (RendererState, mark_untrained_grid, render,
                               run_grid, update_extra_state)
from .metrics import PSNRMeter


def default_optimizer(params, opt):
    """Adam(betas (0.9, 0.99), eps 1e-15) with the reference's
    lr * 0.1^(step / iters) decay (main_nerf.py:114-121), as the JAX
    package's optax chain. Returns (optimizer, scheduler); stepping the
    scheduler after every update gives update i the rate of step i, as
    optax's schedule reads the count before it increments."""
    lr = float(getattr(opt, "lr", 1e-2))
    iters = max(int(getattr(opt, "iters", 30000)), 1)
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99),
                                 eps=1e-15)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 0.1 ** min(step / iters, 1.0))
    return optimizer, scheduler


class Trainer:
    """Trains `net` (a trainable `NeRFNetworkMip`) in place. opt carries
    the JAX trainer's knobs (argparse-style attributes)."""

    def __init__(self, opt, net, ema_decay=None):
        cfg = net.cfg
        if not cfg.grid_ray:
            raise NotImplementedError("the port trains through the occupancy"
                                      " march only (cfg.grid_ray)")
        if cfg.bg_radius > 0:
            raise NotImplementedError("the background net is not ported")
        self.opt = opt
        self.net = net
        self.device = net.hash.device
        self.params = [p for p in net.param_list() if p.requires_grad]
        if not self.params:
            raise ValueError("the net has no trainable parameters")
        self.optimizer, self.scheduler = default_optimizer(self.params, opt)
        self.ema_decay = ema_decay
        self.ema_params = None if ema_decay is None else \
            [p.detach().clone() for p in self.params]
        self.renderer_state = RendererState.create(
            cfg.cascade, cfg.grid_size, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            getattr(opt, "seed", 0) + 1)
        self.epoch = 0
        self.global_step = 0
        self.local_step = 0
        self._grid_block = 0
        # the epochs' mean losses, every step's loss, and each evaluation's
        # mean loss and PSNR (floats)
        self.stats = {"loss": [], "step_loss": [], "valid_loss": [],
                      "results": []}
        self.metrics = [PSNRMeter()]

    # ------------------------------------------------------------- phases
    def _grid_max_samples(self):
        """Slot count of the march: fewer slots once the grid has carved."""
        warmup = getattr(self.opt, "grid_warmup_steps", 0)
        if warmup and self.global_step >= warmup:
            return getattr(self.opt, "grid_max_samples_after_warmup", 32)
        return getattr(self.opt, "grid_max_samples", 64)

    def _budget_per_ray(self):
        """Samples a ray may query: a wide budget while the grid carves,
        the tighter one after (trainer.py:251-269)."""
        warmup = getattr(self.opt, "grid_warmup_steps", 0)
        if warmup and self.global_step >= warmup:
            return getattr(self.opt, "grid_budget_after_warmup", 16)
        return getattr(self.opt, "grid_sample_budget_per_ray", 16)

    # --------------------------------------------------------------- steps
    def train_step(self, data, bg=None, perturb=None):
        """One optimisation step on a batch {'rays_o', 'rays_d' [B, N, 3],
        'images' [B, N, C]}. bg ([B, N, 3] uniforms for an RGBA target)
        and perturb ([B * N] march jitter) are drawn from the trainer's
        generator unless handed in. Returns (pred [B * N, 3], loss []),
        both detached."""
        opt = self.opt
        images = data["images"]
        img_rgb = images[..., :3]
        if getattr(opt, "color_space", "srgb") == "linear":
            img_rgb = srgb_to_linear(img_rgb)
        if images.shape[-1] == 4:
            if bg is None:
                bg = torch.rand(img_rgb.shape, generator=self.generator,
                                device=self.device)
            alpha = images[..., 3:]
            gt = img_rgb * alpha + bg * (1 - alpha)
        else:
            bg = torch.ones_like(img_rgb)
            gt = img_rgb
        flat_o = data["rays_o"].reshape(-1, 3)
        out = run_grid(
            self.net, self.renderer_state, flat_o,
            data["rays_d"].reshape(-1, 3),
            max_samples=self._grid_max_samples(),
            max_steps=getattr(opt, "max_steps", 1024),
            dt_gamma=getattr(opt, "dt_gamma", 0.0),
            bg_color=bg.reshape(-1, 3),
            perturb=self.generator if perturb is None else perturb,
            samples_per_hit=getattr(opt, "grid_samples_per_hit", 1),
            sample_budget=flat_o.shape[0] * self._budget_per_ray())
        pred = out["image"]
        loss = torch.mean((pred - gt.reshape(-1, 3)) ** 2)

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema_params, self.params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        return pred.detach(), loss.detach()

    def _maybe_refresh(self, jitter=None):
        """The occupancy refresh, every `update_extra_interval` steps:
        full while the grid carves (up to grid_warmup_steps), then the
        morton-strided block `_grid_block` of `grid_partial_blocks`, in
        rotation. It probes through a table folded from the current
        parameters. `jitter` hands in the probe draws."""
        opt = self.opt
        if self.global_step % getattr(opt, "update_extra_interval", 16):
            return
        warmup = getattr(opt, "grid_warmup_steps", 0)
        n_blocks = int(getattr(opt, "grid_partial_blocks", 4))
        gs = self.net.cfg.grid_size
        if self.global_step <= warmup or n_blocks <= 1 \
                or gs ** 3 % n_blocks:
            n_blocks, block = 1, 0
        else:
            block = self._grid_block
            self._grid_block = (block + 1) % n_blocks
        with torch.no_grad():
            self.net.to_folded()
            self.renderer_state = update_extra_state(
                self.net, self.renderer_state, generator=self.generator,
                jitter=jitter, grid_size=gs, n_blocks=n_blocks, block=block)

    def iteration(self, data, bg=None, perturb=None, jitter=None):
        """One iteration of the epoch loop: the refresh on its schedule,
        then a step (the step count goes up first, as in the JAX loop).
        Returns (pred, loss)."""
        self._maybe_refresh(jitter)
        self.local_step += 1
        self.global_step += 1
        return self.train_step(data, bg=bg, perturb=perturb)

    # -------------------------------------------------------------- epochs
    def train_one_epoch(self, loader):
        """Returns the epoch's mean loss."""
        self.local_step = 0
        losses = [self.iteration(data)[1] for data in loader]
        if not losses:
            return 0.0
        losses = torch.stack(losses).cpu()       # one wait for the epoch
        self.stats["step_loss"].extend(losses.tolist())
        avg = float(losses.sum()) / len(losses)
        self.stats["loss"].append(avg)
        return avg

    def start(self, dataset):
        """Mark the cells no training camera sees (once, before the first
        epoch, as the JAX `train` does)."""
        self.renderer_state = mark_untrained_grid(
            self.net.cfg, self.renderer_state, dataset.poses,
            dataset.intrinsics, grid_size=self.net.cfg.grid_size)

    def train(self, train_loader, max_epochs: int, on_epoch=None):
        """Epochs self.epoch + 1 .. max_epochs over the loader;
        `on_epoch(self)` runs after each."""
        self.start(train_loader._data)
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader)
            if on_epoch is not None:
                on_epoch(self)

    # ---------------------------------------------------------- evaluation
    def eval_net(self):
        """The net that evaluation renders (trainer.py:570-571): the
        trained one, or the same net with the EMA parameters where the
        trainer keeps them; folded for inference."""
        net = self.net
        if self.ema_params is not None:
            ws = self.ema_params
            if len(ws) != len(net.param_list()):
                raise ValueError("the EMA does not cover every parameter")
            n_pyr, n_sig = len(net.pyramid), len(net.sigma_net)
            net = make_network(net.cfg, {
                "encoder": {"pyramid": ws[:n_pyr], "hash": ws[n_pyr]},
                "sigma_net": ws[n_pyr + 1:n_pyr + 1 + n_sig],
                "color_net": ws[n_pyr + 1 + n_sig:]}, device=self.device)
        with torch.no_grad():
            return net.to_folded()

    def eval_step(self, data, net=None):
        """One batch of whole views {'rays_o', 'rays_d' [B, H * W, 3],
        'images' [B, H, W, C]} through the staged render (trainer.py:
        573-591: max_ray_batch, num_steps and upsample_steps from opt,
        white background). Returns (pred_rgb [B, H, W, 3], pred_depth [B,
        H, W], gt_rgb [B, H, W, 3], loss float)."""
        opt = self.opt
        images = data["images"]
        B, H, W, C = images.shape
        img_rgb = images[..., :3]
        if getattr(opt, "color_space", "srgb") == "linear":
            img_rgb = srgb_to_linear(img_rgb)
        gt_rgb = img_rgb if C == 3 else \
            img_rgb * images[..., 3:] + (1 - images[..., 3:])
        with torch.no_grad():
            out = render(net or self.eval_net(), data["rays_o"],
                         data["rays_d"], staged=True,
                         max_ray_batch=getattr(opt, "max_ray_batch", 4096),
                         num_steps=getattr(opt, "num_steps", 128),
                         upsample_steps=getattr(opt, "upsample_steps", 128),
                         bg_color=1.0)
        pred_rgb = out["image"].reshape(B, H, W, 3)
        pred_depth = out["depth"].reshape(B, H, W)
        loss = float(torch.mean((pred_rgb - gt_rgb) ** 2))
        return pred_rgb, pred_depth, gt_rgb, loss

    def evaluate_one_epoch(self, loader):
        """Every view of `loader` through `eval_step` (trainer.py:593-622):
        the mean loss, returned and kept in stats['valid_loss'], and the
        PSNR meter's mean, kept in stats['results']."""
        for metric in self.metrics:
            metric.clear()
        net = self.eval_net()
        total_loss, count = 0.0, 0
        for data in loader:
            pred, _, gt, loss = self.eval_step(data, net)
            total_loss += loss
            count += 1
            for metric in self.metrics:
                metric.update(pred, gt)
        avg = total_loss / max(count, 1)
        self.stats["valid_loss"].append(avg)
        self.stats["results"].append(
            self.metrics[0].measure() if self.metrics else avg)
        return avg

    def evaluate(self, loader):
        return self.evaluate_one_epoch(loader)
