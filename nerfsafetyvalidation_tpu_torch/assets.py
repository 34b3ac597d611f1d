"""Loading the committed assets without JAX.

The training checkpoints (`bench_assets/flagship*.ckpt`, the mip-fold
teacher; `bench_assets/refbb*.ckpt`, the hash-grid reference backbone)
pickle `ml_dtypes.bfloat16` arrays and the JAX package's `RendererState`;
neither package exists where the port runs.
`_Unpickler` maps bfloat16 to its raw bits (uint16; the checkpoints hold no
other uint16 arrays), the state and optax's optimizer states to plain
stand-ins, and refuses every other class outside numpy. `load_checkpoint`
decodes the bits to float32, as bench.py's `_upcast_asset` upcasts the
stored bfloat16 before rendering.
The student pkls (`bench_student*.pkl`) hold float32 numpy `[in, out]`
weight lists; `save_student` writes one as bench.py caches it.
"""

import pickle

import numpy as np
import torch

from .models.renderer import RendererState


class _PickledState:
    """Stand-in for the JAX package's RendererState dataclass."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _PickledTuple(tuple):
    """Stand-in for optax's state namedtuples (a JAX checkpoint's
    'optimizer'): their fields, as a tuple."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return np.uint16            # the bf16 bits, undecoded
        if name == "RendererState" and module.endswith("models.renderer"):
            return _PickledState
        if module == "optax" or module.startswith("optax."):
            return _PickledTuple
        if module != "numpy" and not module.startswith("numpy."):
            raise pickle.UnpicklingError(f"refusing {module}.{name}")
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError:     # numpy 1.x names numpy._core core
            return super().find_class(module.replace("numpy._core",
                                                     "numpy.core"), name)


def _load(path):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the same values as float32."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32)
            << 16).view(np.float32)


def _upcast(x):
    """Decode every bf16-bits array of a pytree (dicts and lists)."""
    if isinstance(x, dict):
        return {k: _upcast(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_upcast(v) for v in x)
    if isinstance(x, np.ndarray) and x.dtype == np.uint16:
        return _bf16_bits_to_f32(x)
    return x


def load_student(path):
    """Student params {'sigma_net': [...], 'color_net': [...]}, float32
    numpy [in, out] arrays."""
    blob = _load(path)
    return blob["params"] if "params" in blob else blob


def save_student(path, params, schedule, K, hidden, layers):
    """Write a student's params pytree ({'sigma_net': [...], 'color_net':
    [...]}, [in, out] tensors or arrays) as bench.py's `_get_student`
    caches it (bench.py:345-350): {'params': the weights as float32 numpy
    [in, out] arrays, 'schedule': (distill steps, fine-tune steps), 'K',
    'hidden_dim', 'num_layers'}. `load_student` and the JAX package's
    student nets read it back."""
    def host(w):
        if isinstance(w, torch.Tensor):
            w = w.detach().to("cpu", torch.float32).numpy()
        return np.array(w, dtype=np.float32)
    blob = {"params": {k: [host(w) for w in params[k]]
                       for k in ("sigma_net", "color_net")},
            "schedule": tuple(int(s) for s in schedule), "K": int(K),
            "hidden_dim": int(hidden), "num_layers": int(layers)}
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_renderer_state(path, device="cuda") -> RendererState:
    """The occupancy bitfield stored in a training checkpoint (the other
    fields are left empty)."""
    bits = _load(path)["renderer_state"].density_bitfield
    return RendererState(density_bitfield=torch.as_tensor(
        np.asarray(bits, dtype=np.uint8), device=device))


def load_checkpoint(path, device="cuda"):
    """The trained field of a training checkpoint: (params, state). params
    is the JAX package's pytree as float32 tensors ({'encoder': {'pyramid':
    [...], 'hash': ...}, 'sigma_net': [...], 'color_net': [...]} for the
    mip-fold teacher, {'encoder': {'embeddings': ...}, ...} for a hash
    grid); state is the full RendererState, the density grid and mean
    density as float32."""
    blob = _load(path)
    state = renderer_state_from(blob["renderer_state"].__dict__, device)
    return params_from_jax(_upcast(blob["model"]), device), state


def renderer_state_from(fields, device="cuda") -> RendererState:
    """A RendererState from a checkpoint's fields (a dict of arrays, the
    bf16 ones as bits): the density grid and mean density as float32."""
    rs = _upcast(dict(fields))
    skip = rs.get("skip_grid")
    return RendererState(
        density_bitfield=torch.as_tensor(
            np.asarray(rs["density_bitfield"], dtype=np.uint8),
            device=device),
        density_grid=torch.as_tensor(
            np.asarray(rs["density_grid"], dtype=np.float32), device=device),
        mean_density=torch.as_tensor(
            np.asarray(rs["mean_density"], dtype=np.float32), device=device),
        iter_density=torch.as_tensor(
            np.asarray(rs["iter_density"], dtype=np.int32), device=device),
        skip_grid=None if skip is None else torch.as_tensor(
            np.asarray(skip, dtype=np.uint8), device=device))


def params_from_jax(tree, device="cuda"):
    """A params pytree of the JAX package (nested dicts and lists of numpy
    or array-like leaves) as float32 tensors on `device`, same nesting. A
    leaf may be a flat sigma-net vector of the JAX nets'
    `get_sigma_net_flat`: the port's `set_sigma_net_flat` takes it as it
    is (the same layout, bit for bit, both ways)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree, dtype=np.float32), device=device)
