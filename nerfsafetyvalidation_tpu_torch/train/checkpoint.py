"""Checkpoints of the trainer (nerfsafetyvalidation_tpu/train/
checkpoint.py, `CheckpointManager` with its pickle backend).

The file layout is the JAX package's: a pickle of {'format_version': 2,
'epoch', 'global_step', 'stats', 'model'} with the parameters as a numpy
pytree ({'encoder': {...}, 'sigma_net': [...], 'color_net': [...]}), and
'renderer_state' (a dict of numpy arrays) unless it is the best file;
`full` adds 'ema' (a numpy pytree) and the optimizer. Torch's Adam and its
learning-rate schedule go under a key of their own, 'torch_optimizer'
(their state dicts, tensors as numpy), never under 'optimizer', which
holds optax's state in the JAX package's files: neither package reads the
other's optimizer. Files are `{name}_ep{epoch:04d}.ckpt`, the last
`max_keep` of them kept, and `{name}.ckpt` for the best; each is written to
a temporary file and renamed, so a killed save leaves no truncated file.

A file of either package loads through `assets._Unpickler`, which builds
numpy arrays and stand-ins and no other class (optax's states become
tuples)."""

import glob
import os
import pickle

import numpy as np
import torch

from ..assets import _load, _upcast, renderer_state_from

FORMAT_VERSION = 2


def to_numpy(tree):
    """Tensors of a nested dict / list / tuple as numpy arrays (float32
    stays float32), the nesting and every other leaf kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def to_torch(tree):
    """to_numpy's inverse: numpy arrays (and numpy scalars) as tensors."""
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(tree))
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree


def state_to_numpy(state):
    """A RendererState as the dict of numpy arrays a checkpoint holds."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in vars(state).items()}


class CheckpointManager:
    def __init__(self, ckpt_path: str, name: str = "ngp", max_keep: int = 2):
        self.ckpt_path = ckpt_path
        self.name = name
        self.max_keep = max_keep
        os.makedirs(ckpt_path, exist_ok=True)
        self.best_path = os.path.join(ckpt_path, f"{name}.ckpt")
        self.saved = []

    def _file(self, epoch: int) -> str:
        return os.path.join(self.ckpt_path, f"{self.name}_ep{epoch:04d}.ckpt")

    def save(self, epoch, global_step, params, stats=None, optimizer=None,
             ema_params=None, renderer_state=None, full=False, best=False,
             best_result=None):
        """params / ema_params: pytrees of tensors; optimizer: the torch
        state dicts to keep under 'torch_optimizer'; renderer_state: a
        RendererState. Returns the path written."""
        state = {"format_version": FORMAT_VERSION, "epoch": int(epoch),
                 "global_step": int(global_step), "stats": stats or {},
                 "model": to_numpy(params)}
        if renderer_state is not None and not best:
            state["renderer_state"] = state_to_numpy(renderer_state)
        if full:
            if optimizer is not None:
                state["torch_optimizer"] = to_numpy(optimizer)
            if ema_params is not None:
                state["ema"] = to_numpy(ema_params)
        if best:
            if best_result is not None:
                state["best_result"] = float(best_result)
            path = self.best_path
        else:
            path = self._file(epoch)
            self.saved.append(path)
            while len(self.saved) > self.max_keep:
                old = self.saved.pop(0)
                if os.path.exists(old):
                    os.remove(old)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)
        return path

    def resolve(self, which: str = "latest"):
        """A checkpoint's path, or None: 'scratch' none; 'best' the best
        file, else the latest; 'latest' / 'latest_model' the newest epoch
        file that reads; anything else a path, if it exists."""
        if which == "scratch":
            return None
        if which == "best":
            return self.best_path if os.path.exists(self.best_path) \
                else self.resolve("latest")
        if which in ("latest", "latest_model"):
            ckpts = sorted(glob.glob(os.path.join(
                self.ckpt_path, f"{self.name}_ep*.ckpt")))
            for path in reversed(ckpts):     # newest first; skip truncated
                try:
                    _load(path)
                    return path
                except Exception:
                    print(f"[WARN] skipping unreadable checkpoint {path}")
            return None
        return which if os.path.exists(which) else None

    @staticmethod
    def load(path: str, device="cpu"):
        """The checkpoint's dict: 'model' and 'ema' as float32 tensor
        pytrees on `device` (bf16 decoded), 'renderer_state' as a
        RendererState, 'torch_optimizer' with tensors; the rest as
        stored."""
        state = _load(path)
        for k in ("model", "ema"):
            if k in state:
                state[k] = to_torch(_upcast(state[k]))
                state[k] = _to_device(state[k], device)
        if "renderer_state" in state:
            rs = state["renderer_state"]
            state["renderer_state"] = renderer_state_from(
                rs if isinstance(rs, dict) else vars(rs), device)
        if "torch_optimizer" in state:
            state["torch_optimizer"] = to_torch(state["torch_optimizer"])
        return state


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return [_to_device(v, device) for v in tree]
