"""The training loop of the port (nerfsafetyvalidation_tpu/train/
trainer.py, `Trainer`), for any net with `param_list()`: the mip-fold
teacher, `NeRFNetwork` (any encoding, with or without the background net),
`NeRFNetworkFF` and `NeRFNetworkTCNN`.

One iteration: with cfg.grid_ray, the occupancy refresh on its schedule
(every `update_extra_interval` steps; full probes while the grid still
carves, then one of 4 morton-strided blocks in rotation; a mip-fold net
probes through a freshly folded table), then one step: the pixel-wise
random background for RGBA targets (white where the net has a background
net), the render (with cfg.grid_ray the
marched `run_grid` with the phased sample budget; else the uniform `run`
with jittered samples and, with `upsample_steps`, samples drawn from the
pdf), the MSE (the mean of the per-ray means), the backward, the Adam
update, the learning-rate decay, where `ema_decay` is set the per-step EMA
and, where the training split keeps an error map (`--error_map`), its
update on the host: 0.1 * old + 0.9 * the rays' errors at their coarse
cells, the last of duplicate cells winning, as numpy's put_along_axis in
the JAX trainer (trainer.py:330-337). `train` runs epochs over a
loader, saves a checkpoint every `ckpt_interval` epochs and the last, and
evaluates every `eval_interval` epochs, keeping the best file.
Evaluation (`eval_step`, `evaluate_one_epoch`, `evaluate`) renders whole
views through the staged uniform-sampling render, on the EMA parameters
where there are some, scores them with the PSNR meter and, with a
workspace, writes each view's PNG; `test` renders a split's views in
`--render_mode` staged, fast, guided or scout with the JAX trainer's
settings (trainer.py:627-705; the last three need the occupancy state,
and without it fall back to staged with JAX's warning) and writes mp4s
through imageio where it has a backend, else RGB and depth PNGs, as the
JAX trainer does; `save_mesh` writes the density's iso-surface as a .ply
(`mesh_export`, the density probed on the net's device).

The JAX trainer jits the step; here it runs eagerly. Its random draws
(background, march jitter or sample jitter and pdf draws, refresh jitter)
come from a torch.Generator seeded `opt.seed + 1`, or are handed in, as
the tests hand in the JAX trainer's own draws. With `fold_warmup_scale` w
on a mip-fold net, the steps before `grid_warmup_steps` train the same
parameters through the net folding its dense levels at w
(`NeRFNetworkMip.at_fold_scale`; JAX's `_phase_net`), chosen again at
every step for a net with cfg.grid_ray and once, when the trainer is built,
for any other, as the JAX trainer rebuilds its jitted step (trainer.py:
300-304). A fused mip-fold net trains through K3 forward and backward. Not
ported: CLIP guidance, data parallelism and the fused multi-step scan.
"""

import os
import time

import numpy as np
import torch

from ..data.png import write_png
from ..data.rays import linear_to_srgb, srgb_to_linear
from ..models.network import mlp_leaves
from ..models.renderer import (RendererState, mark_untrained_grid, render,
                               render_frame_fast, render_frame_guided, run,
                               run_grid, update_extra_state)
from .checkpoint import CheckpointManager
from .mesh_export import extract_geometry, write_ply
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


def param_leaves(tree):
    """A params pytree's tensors in the nets' `param_list` order: the
    encoder's (pyramid grids and hash table, or the table), the sigma net,
    the color net (a biased layer {'w', 'b'} as w then b), the background
    table and the background net."""
    enc = tree.get("encoder", {})
    leaves = list(enc.get("pyramid", [])) + [enc[k] for k in
                                             ("hash", "embeddings")
                                             if k in enc]
    leaves += mlp_leaves(tree["sigma_net"]) + mlp_leaves(tree["color_net"])
    if "encoder_bg" in tree:
        leaves += [tree["encoder_bg"]["embeddings"], *tree["bg_net"]]
    return leaves


def update_error_map(error_map, index, inds_coarse, per_ray):
    """The JAX trainer's error-map EMA (trainer.py:330-337), on the host:
    error_map [V, cells] float32 numpy, updated in place at the views
    `index` [B] and cells inds_coarse [B, N] to 0.1 * old + 0.9 * per_ray
    ([B * N], each ray's mean squared error); where a cell repeats, the
    last of its rays is kept, as numpy's put_along_axis keeps it."""
    inds = np.asarray(inds_coarse)
    err = np.asarray(per_ray, dtype=np.float32).reshape(inds.shape)
    emap = error_map[index]
    ema_error = 0.1 * np.take_along_axis(emap, inds, axis=1) + 0.9 * err
    np.put_along_axis(emap, inds, ema_error, axis=1)
    error_map[index] = emap


def _png8(img):
    return (np.asarray(img) * 255).clip(0, 255).astype(np.uint8)


class Trainer:
    """Trains `net` (a trainable net with `param_list()`) in place. opt
    carries the JAX trainer's knobs (argparse-style attributes). With a
    `workspace`, the trainer logs to `log_{name}.txt` there, keeps its
    checkpoints under `checkpoints/` and, unless `use_checkpoint` is
    'scratch', starts from the one it names ('latest', 'latest_model',
    'best' or a path), as the JAX trainer does."""

    def __init__(self, opt, net, ema_decay=None, name: str = "ngp",
                 workspace=None, use_checkpoint: str = "latest",
                 eval_interval: int = 1, max_keep_ckpt: int = 2,
                 ckpt_interval: int = 1, mute: bool = False):
        cfg = net.cfg
        self.name = name
        self.opt = opt
        self.net = net
        self.mute = mute
        self.workspace = workspace
        self.eval_interval = eval_interval
        self.ckpt_interval = max(1, int(ckpt_interval))
        self.params = [p for p in net.param_list() if p.requires_grad]
        if len(self.params) != len(net.param_list()):
            raise ValueError("the net is not trainable (build it with "
                             "trainable=True)")
        self.device = self.params[0].device
        self.optimizer, self.scheduler = default_optimizer(self.params, opt)
        self.ema_decay = ema_decay
        self.ema_params = None if ema_decay is None else \
            [p.detach().clone() for p in self.params]
        self.renderer_state = RendererState.create(
            cfg.cascade, cfg.grid_size, device=self.device) \
            if cfg.grid_ray else None
        self.generator = torch.Generator(device=self.device).manual_seed(
            getattr(opt, "seed", 0) + 1)
        self.epoch = 0
        self.global_step = 0
        self.local_step = 0
        self._grid_block = 0
        # the training split's error map [V, cells] (numpy), set by `start`
        self.error_map = None
        # the fold_warmup_scale net (`_phase_net`), made at first use
        self._net_warm = None
        # the epochs' mean losses, every step's loss, each evaluation's
        # mean loss and PSNR (floats), the checkpoints written
        self.stats = {"loss": [], "step_loss": [], "valid_loss": [],
                      "results": [], "checkpoints": [], "best_result": None}
        # seconds of each training epoch (host clock; each ends waiting for
        # its losses, so for the device)
        self.epoch_times = []
        self.psnr = PSNRMeter()
        self.log_ptr = None
        self.ckpt = None
        if workspace is not None:
            os.makedirs(workspace, exist_ok=True)
            self.log_ptr = open(os.path.join(workspace, f"log_{name}.txt"),
                                "a+")
            self.ckpt = CheckpointManager(os.path.join(workspace,
                                                       "checkpoints"),
                                          name=name, max_keep=max_keep_ckpt)
        n_params = sum(p.numel() for p in self.params)
        self.log(f"[INFO] Trainer: {name} | "
                 f"{time.strftime('%Y-%m-%d_%H-%M-%S')} | {self.device} | "
                 f"{cfg.compute_dtype} | {workspace}")
        self.log(f"[INFO] #parameters: {n_params}")
        if self.ckpt is not None:
            if use_checkpoint == "scratch":
                self.log("[INFO] Training from scratch ...")
            else:
                path = self.ckpt.resolve(use_checkpoint)
                if path is None:
                    self.log(f"[INFO] no checkpoint for {use_checkpoint!r}, "
                             "training from scratch")
                else:
                    self.log(f"[INFO] Loading {path} ...")
                    self.load_checkpoint(
                        path, model_only=use_checkpoint == "latest_model")
        # the net the steps train through (see train_step)
        self._step_net = self._phase_net()

    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)
        if self.log_ptr:
            print(*args, file=self.log_ptr, flush=True)

    # ------------------------------------------------------------- phases
    def _grid_max_samples(self):
        """Slot count of the march: fewer slots once the grid has carved."""
        warmup = getattr(self.opt, "grid_warmup_steps", 0)
        if warmup and self.global_step >= warmup:
            return getattr(self.opt, "grid_max_samples_after_warmup", 32)
        return getattr(self.opt, "grid_max_samples", 64)

    def _phase_net(self):
        """The net of the current phase (trainer.py:229-250): with
        opt.fold_warmup_scale w on a mip-fold net, while global_step <
        grid_warmup_steps, the same net folding at w; else the net."""
        w = int(getattr(self.opt, "fold_warmup_scale", 0) or 0)
        if not w or self.net.cfg.encoding != "mipfold":
            return self.net
        warmup = getattr(self.opt, "grid_warmup_steps", 0)
        if warmup and self.global_step >= warmup:
            return self.net
        if self._net_warm is None:
            self._net_warm = self.net.at_fold_scale(w)
        return self._net_warm

    def _budget_per_ray(self):
        """Samples a ray may query: a wide budget while the grid carves,
        the tighter one after (trainer.py:251-269)."""
        warmup = getattr(self.opt, "grid_warmup_steps", 0)
        if warmup and self.global_step >= warmup:
            return getattr(self.opt, "grid_budget_after_warmup", 16)
        return getattr(self.opt, "grid_sample_budget_per_ray", 16)

    # --------------------------------------------------------------- steps
    def train_step(self, data, bg=None, perturb=None, draws=None):
        """One optimisation step on a batch {'rays_o', 'rays_d' [B, N, 3],
        'images' [B, N, C]}. The draws come from the trainer's generator
        unless handed in: bg ([B, N, 3] uniforms for an RGBA target);
        with cfg.grid_ray perturb ([B * N] march jitter), else draws
        ({'perturb': [B * N, num_steps], 'pdf': [B * N, upsample_steps]},
        see `run`). With an error map and a batch that carries 'index' and
        'inds_coarse', the map is updated. Returns (pred [B * N, 3], loss
        []), both detached."""
        opt = self.opt
        images = data["images"]
        img_rgb = images[..., :3]
        if getattr(opt, "color_space", "srgb") == "linear":
            img_rgb = srgb_to_linear(img_rgb)
        if images.shape[-1] == 4 and self.net.cfg.bg_radius <= 0:
            # pixel-wise random background (utils.py:439-442)
            if bg is None:
                bg = torch.rand(img_rgb.shape, generator=self.generator,
                                device=self.device)
            alpha = images[..., 3:]
            gt = img_rgb * alpha + bg * (1 - alpha)
        else:
            bg = torch.ones_like(img_rgb)
            gt = img_rgb if images.shape[-1] == 3 else \
                img_rgb * images[..., 3:] + (1 - images[..., 3:])
        flat_o = data["rays_o"].reshape(-1, 3)
        flat_d = data["rays_d"].reshape(-1, 3)
        if self.net.cfg.grid_ray:
            self._step_net = self._phase_net()
            out = run_grid(
                self._step_net, self.renderer_state, flat_o, flat_d,
                max_samples=self._grid_max_samples(),
                max_steps=getattr(opt, "max_steps", 1024),
                dt_gamma=getattr(opt, "dt_gamma", 0.0),
                bg_color=bg.reshape(-1, 3),
                perturb=self.generator if perturb is None else perturb,
                samples_per_hit=getattr(opt, "grid_samples_per_hit", 1),
                sample_budget=flat_o.shape[0] * self._budget_per_ray())
        else:
            out = run(self._step_net, flat_o, flat_d,
                      num_steps=getattr(opt, "num_steps", 128),
                      upsample_steps=getattr(opt, "upsample_steps", 128),
                      bg_color=bg.reshape(-1, 3), perturb=True,
                      generator=self.generator, training=True, draws=draws)
        pred = out["image"]
        per_ray = torch.mean((pred - gt.reshape(-1, 3)) ** 2, dim=-1)
        loss = torch.mean(per_ray)

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema_params, self.params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        if self.error_map is not None and "index" in data:
            update_error_map(self.error_map, data["index"],
                             data["inds_coarse"].cpu(),
                             per_ray.detach().cpu())
        return pred.detach(), loss.detach()

    def _maybe_refresh(self, jitter=None):
        """With cfg.grid_ray, the occupancy refresh every
        `update_extra_interval` steps: full while the grid carves (up to
        grid_warmup_steps), then the morton-strided block `_grid_block` of
        `grid_partial_blocks`, in rotation; a mip-fold net probes through a
        table folded from the current parameters. `jitter` hands in the
        probe draws."""
        opt = self.opt
        if self.renderer_state is None or \
                self.global_step % getattr(opt, "update_extra_interval", 16):
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
            if hasattr(self.net, "to_folded"):
                self.net.to_folded()
            self.renderer_state = update_extra_state(
                self.net, self.renderer_state, generator=self.generator,
                jitter=jitter, grid_size=gs, n_blocks=n_blocks, block=block)

    def iteration(self, data, bg=None, perturb=None, jitter=None,
                  draws=None):
        """One iteration of the epoch loop: the refresh on its schedule,
        then a step (the step count goes up first, as in the JAX loop).
        Returns (pred, loss)."""
        self._maybe_refresh(jitter)
        self.local_step += 1
        self.global_step += 1
        return self.train_step(data, bg=bg, perturb=perturb, draws=draws)

    # -------------------------------------------------------------- epochs
    def train_one_epoch(self, loader):
        """Returns the epoch's mean loss."""
        self.log(f"==> Start Training Epoch {self.epoch} ...")
        t0 = time.perf_counter()
        self.local_step = 0
        losses = [self.iteration(data)[1] for data in loader]
        avg = 0.0
        if losses:
            losses = torch.stack(losses).cpu()   # one wait for the epoch
            self.stats["step_loss"].extend(losses.tolist())
            avg = float(losses.sum()) / len(losses)
        self.stats["loss"].append(avg)
        self.epoch_times.append(time.perf_counter() - t0)
        self.log(f"==> Finished Epoch {self.epoch}. avg loss {avg:.6f} "
                 f"({self.epoch_times[-1]:.2f} s)")
        return avg

    def start(self, dataset):
        """With cfg.grid_ray, mark the cells no training camera sees (once,
        before the first epoch, as the JAX `train` does); take the
        dataset's error map (None without `--error_map`)."""
        self.error_map = getattr(dataset, "error_map", None)
        if self.renderer_state is not None:
            self.renderer_state = mark_untrained_grid(
                self.net.cfg, self.renderer_state, dataset.poses,
                dataset.intrinsics, grid_size=self.net.cfg.grid_size)

    def train(self, train_loader, valid_loader, max_epochs: int,
              on_epoch=None):
        """Epochs self.epoch + 1 .. max_epochs over train_loader
        (trainer.py:544-560): a full checkpoint every `ckpt_interval`
        epochs and after the last, an evaluation on valid_loader every
        `eval_interval` epochs followed by the best file; `on_epoch(self)`
        runs after each epoch."""
        self.start(train_loader._data)
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader)
            if self.ckpt is not None and (
                    epoch % self.ckpt_interval == 0 or epoch == max_epochs):
                self.save_checkpoint(full=True, best=False)
            if valid_loader is not None and \
                    self.epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_loader)
                if self.ckpt is not None:
                    self.save_checkpoint(full=False, best=True)
            if on_epoch is not None:
                on_epoch(self)

    # ---------------------------------------------------------- evaluation
    def eval_net(self):
        """The net that evaluation renders (trainer.py:570-571): the
        trained one, or the same net with the EMA parameters where the
        trainer keeps them; a mip-fold net folded for inference."""
        net = self.net
        if self.ema_params is not None:
            if len(self.ema_params) != len(net.param_list()):
                raise ValueError("the EMA does not cover every parameter")
            net = type(net)(net.cfg, net.params_tree(self.ema_params),
                            device=self.device)
        if hasattr(net, "to_folded"):
            with torch.no_grad():
                net.to_folded()
        return net

    def _render_views(self, net, data, bg_color=None):
        opt = self.opt
        with torch.no_grad():
            return render(net, data["rays_o"], data["rays_d"], staged=True,
                          max_ray_batch=getattr(opt, "max_ray_batch", 4096),
                          num_steps=getattr(opt, "num_steps", 128),
                          upsample_steps=getattr(opt, "upsample_steps", 128),
                          bg_color=bg_color)

    def eval_step(self, data, net=None):
        """One batch of whole views {'rays_o', 'rays_d' [B, H * W, 3],
        'images' [B, H, W, C]} through the staged render (trainer.py:
        573-591: max_ray_batch, num_steps and upsample_steps from opt,
        white background). Returns (pred_rgb [B, H, W, 3], pred_depth [B,
        H, W], gt_rgb [B, H, W, 3], loss float)."""
        images = data["images"]
        B, H, W, C = images.shape
        img_rgb = images[..., :3]
        if getattr(self.opt, "color_space", "srgb") == "linear":
            img_rgb = srgb_to_linear(img_rgb)
        gt_rgb = img_rgb if C == 3 else \
            img_rgb * images[..., 3:] + (1 - images[..., 3:])
        out = self._render_views(net or self.eval_net(), data, bg_color=1.0)
        pred_rgb = out["image"].reshape(B, H, W, 3)
        pred_depth = out["depth"].reshape(B, H, W)
        loss = float(torch.mean((pred_rgb - gt_rgb) ** 2))
        return pred_rgb, pred_depth, gt_rgb, loss

    def evaluate_one_epoch(self, loader, name=None):
        """Every view of `loader` through `eval_step` (trainer.py:593-622):
        the mean loss, returned and kept in stats['valid_loss'], and the
        PSNR meter's mean, kept in stats['results']; with a workspace each
        view's PNG under validation/."""
        self.log(f"++> Evaluate at epoch {self.epoch} ...")
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"
        self.psnr.clear()
        net = self.eval_net()
        total_loss, count = 0.0, 0
        for i, data in enumerate(loader):
            pred, _, gt, loss = self.eval_step(data, net)
            total_loss += loss
            count += 1
            self.psnr.update(pred, gt)
            if self.workspace is not None:
                out_dir = os.path.join(self.workspace, "validation")
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"{name}_{i:04d}_rgb.png"),
                          _png8(pred[0].cpu()))
        avg = total_loss / max(count, 1)
        self.stats["valid_loss"].append(avg)
        self.stats["results"].append(self.psnr.measure())
        self.log(self.psnr.report())
        self.log(f"++> Evaluate epoch {self.epoch} Finished. loss "
                 f"{avg:.6f}")
        return avg

    def evaluate(self, loader, name=None):
        return self.evaluate_one_epoch(loader, name)

    def _render_test_view(self, net, data, mode):
        """One test view in `mode` (trainer.py:641-671)."""
        opt = self.opt
        H, W = data["H"], data["W"]
        o, d = data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3)
        march = dict(max_steps=getattr(opt, "max_steps", 1024),
                     dt_gamma=getattr(opt, "dt_gamma", 0.0))
        with torch.no_grad():
            if mode == "fast":
                return render_frame_fast(
                    net, self.renderer_state, o, d,
                    tile=min(131072, -(-(H * W) // 1024) * 1024),
                    max_samples=16, samples_per_hit=2, **march)
            if mode in ("guided", "scout"):
                return render_frame_guided(
                    net, self.renderer_state, o, d, H, W, prepass_factor=8,
                    max_samples=16, prepass_mode="scout" if mode == "scout"
                    else "march", **march)
        return self._render_views(net, data)

    def test(self, loader, save_path=None, name=None, write_video=True):
        """Render the views of `loader` (trainer.py:627-705) in
        opt.render_mode: 'staged' (the staged render: max_ray_batch,
        num_steps, upsample_steps; no background colour given, so white or
        the background net), 'fast' (`render_frame_fast`: a tile of
        min(131072, H * W rounded up to 1024) rays, 16 samples, paired
        emission) or 'guided' / 'scout' (`render_frame_guided`, prepass
        factor 8, 16 samples, a marched or a scout prepass), the marched
        modes with opt's max_steps and dt_gamma on the occupancy state;
        without one they fall back to 'staged' with JAX's warning. With
        `write_video` the frames go to `{name}_rgb.mp4` and
        `{name}_depth.mp4` through imageio; where imageio or its mp4
        backend is missing, and without `write_video`, to PNGs
        `{name}_{i:04d}_rgb.png` and `_depth.png`. Returns the paths."""
        mode = getattr(self.opt, "render_mode", "staged")
        if save_path is None:
            save_path = os.path.join(self.workspace or ".", "results")
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"
        os.makedirs(save_path, exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        if mode != "staged" and self.renderer_state is None:
            self.log(f"[WARN] render_mode={mode} needs the occupancy grid "
                     "(grid-ray training); falling back to staged")
            mode = "staged"
        net = self.eval_net()
        frames = []
        for data in loader:
            H, W = data["H"], data["W"]
            out = self._render_test_view(net, data, mode)
            pred = out["image"].reshape(H, W, 3)
            if getattr(self.opt, "color_space", "srgb") == "linear":
                pred = linear_to_srgb(pred)
            depth = out["depth"].reshape(H, W)
            frames.append((_png8(pred.cpu()), _png8(depth.cpu())))
        paths = []
        if write_video and frames:
            try:
                import imageio
                for k, kind in enumerate(("rgb", "depth")):
                    path = os.path.join(save_path, f"{name}_{kind}.mp4")
                    imageio.mimwrite(path, np.stack([f[k] for f in frames]),
                                     fps=25, quality=8, macro_block_size=1)
                    paths.append(path)
                frames = []
            except (ValueError, ImportError):
                # no mp4 backend: PNG frames instead
                self.log("[WARN] no mp4 backend; writing PNG frames instead")
        for i, imgs in enumerate(frames):
            for kind, img in zip(("rgb", "depth"), imgs):
                path = os.path.join(save_path, f"{name}_{i:04d}_{kind}.png")
                write_png(path, img)
                paths.append(path)
        self.log("==> Finished Test.")
        return paths

    def save_mesh(self, save_path=None, resolution=256, threshold=10):
        """The density's `threshold` iso-surface over the box [-bound,
        bound]^3 as an ASCII .ply (trainer.py:707-724): the density of the
        trained parameters (not the EMA) probed on a resolution^3 grid in
        blocks of 128^3 points on the net's device, polygonised on the
        host (`mesh_export`). Default path `<workspace>/meshes/
        {name}_{epoch}.ply`. Returns (path, stats): stats holds the
        vertex and face counts and the seconds of the probe (each block
        ends waiting for the card), of the polygonisation and of the
        file."""
        if save_path is None:
            save_path = os.path.join(self.workspace or ".", "meshes",
                                     f"{self.name}_{self.epoch}.ply")
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        bound = self.net.cfg.bound
        probe = [0.0]

        def query(pts):
            t0 = time.perf_counter()
            with torch.no_grad():
                sigma = self.net.density(torch.as_tensor(
                    pts, device=self.device))["sigma"].cpu().numpy()
            probe[0] += time.perf_counter() - t0
            return sigma

        t0 = time.perf_counter()
        verts, faces = extract_geometry(
            np.asarray([-bound] * 3), np.asarray([bound] * 3), resolution,
            threshold, query)
        t1 = time.perf_counter()
        write_ply(save_path, verts, faces)
        stats = {"vertices": len(verts), "faces": len(faces),
                 "probe_s": probe[0], "surface_s": t1 - t0 - probe[0],
                 "file_s": time.perf_counter() - t1}
        self.log(f"==> Saved mesh to {save_path}")
        return save_path, stats

    # ---------------------------------------------------------- checkpoint
    def _optimizer_state(self):
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def save_checkpoint(self, full=False, best=False):
        """Through the CheckpointManager (trainer.py:726-742): the best
        file holds the evaluated parameters (the EMA's where there is
        one) and the last result; an epoch file the parameters, the
        occupancy state and, when `full`, the optimizer and the EMA."""
        net = self.net
        if best:
            result = self.stats["results"][-1] if self.stats["results"] \
                else None
            ws = self.ema_params if self.ema_params is not None \
                else self.params
            return self.ckpt.save(self.epoch, self.global_step,
                                  net.params_tree(ws), stats=self.stats,
                                  best=True, best_result=result)
        path = self.ckpt.save(
            self.epoch, self.global_step, net.params_tree(),
            stats=self.stats, optimizer=self._optimizer_state(),
            ema_params=None if self.ema_params is None
            else net.params_tree(self.ema_params),
            renderer_state=self.renderer_state, full=full)
        self.stats["checkpoints"].append(path)
        return path

    def load_checkpoint(self, checkpoint=None, model_only=False):
        """A checkpoint of either package (trainer.py:744-766): its
        parameters into the net, in place; unless `model_only`, the epoch,
        step, stats, occupancy state, the EMA and this package's own
        optimizer state (a JAX file's optax state is left alone)."""
        if checkpoint is None:
            checkpoint = self.ckpt.resolve("latest")
            if checkpoint is None:
                self.log("[WARN] No checkpoint found, model randomly "
                         "initialized.")
                return
        state = CheckpointManager.load(checkpoint, device=self.device)
        if "model" in state:
            with torch.no_grad():
                for p, w in zip(self.net.param_list(),
                                param_leaves(state["model"]), strict=True):
                    p.copy_(w)
        if model_only:
            return
        self.epoch = state.get("epoch", 0)
        self.global_step = state.get("global_step", 0)
        self.stats.update(state.get("stats", {}))
        if "renderer_state" in state and self.renderer_state is not None:
            self.renderer_state = state["renderer_state"]
        if "torch_optimizer" in state:
            self.optimizer.load_state_dict(
                state["torch_optimizer"]["optimizer"])
            self.scheduler.load_state_dict(
                state["torch_optimizer"]["scheduler"])
        if "ema" in state and self.ema_params is not None:
            with torch.no_grad():
                for e, w in zip(self.ema_params, param_leaves(state["ema"]),
                                strict=True):
                    e.copy_(w)
        self.log(f"[INFO] loaded {checkpoint} at epoch {self.epoch}, "
                 f"global step {self.global_step}")
