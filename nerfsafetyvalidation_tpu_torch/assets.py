"""Loading the committed assets without JAX.

`bench_assets/flagship*.ckpt` pickles `ml_dtypes.bfloat16` arrays and the
JAX package's `RendererState`; neither package exists where the port runs.
`_Unpickler` maps bfloat16 to its raw bits (uint16) and the state to a
plain stand-in, and refuses every class outside numpy. The student pkls
(`bench_student*.pkl`) hold float32 numpy `[in, out]` weight lists.
"""

import pickle

import numpy as np
import torch

from .models.renderer import RendererState


class _PickledState:
    """Stand-in for the JAX package's RendererState dataclass."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return np.uint16            # the bf16 bits, undecoded
        if name == "RendererState" and module.endswith("models.renderer"):
            return _PickledState
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


def load_student(path):
    """Student params {'sigma_net': [...], 'color_net': [...]}, float32
    numpy [in, out] arrays."""
    blob = _load(path)
    return blob["params"] if "params" in blob else blob


def load_renderer_state(path, device="cuda") -> RendererState:
    """The occupancy bitfield stored in a training checkpoint."""
    bits = _load(path)["renderer_state"].density_bitfield
    return RendererState(density_bitfield=torch.as_tensor(
        np.asarray(bits, dtype=np.uint8), device=device))


def params_from_jax(tree, device="cuda"):
    """The JAX package's params pytree (numpy or array-likes, lists of
    [in, out] matrices) as float32 tensors on `device`."""
    return {k: [torch.as_tensor(np.asarray(w, dtype=np.float32),
                                device=device) for w in v]
            for k, v in tree.items()}
