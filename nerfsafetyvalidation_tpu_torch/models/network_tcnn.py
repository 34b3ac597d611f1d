"""The tiny-cuda-nn backbone that `--tcnn` builds: the port of the JAX
package's `NeRFNetworkTCNN` (nerfsafetyvalidation_tpu/models/
network_tcnn.py; reference nerf/network_tcnn.py).

The same field as `NeRFNetwork`, with what tiny-cuda-nn changes:

  * both MLPs have biases (`_mlp_bias`: each product in the compute dtype
    with float32 sums, then the float32 bias added, ReLU between layers);
    a layer is {"w": [in, out], "b": [out]}, initialised as torch's
    nn.Linear (both uniform in +-1/sqrt(in));
  * directions are remapped (d + 1) / 2 and back 2x - 1 before the
    spherical harmonics, as tcnn's encoder reads [0, 1] (network_tcnn.py:
    100-101); kept explicit, as the JAX class keeps it;
  * no background net.

`--tcnn` sets cfg.fused, but `density` and `color` never call a kernel, as
in the JAX class (:92-110): the products are plain matmul chains. The JAX
class's inherited `apply` sends a fused frequency-encoded net to the
points kernel, which reads `.shape` of the biased layers and raises
AttributeError ('dict' object has no attribute 'shape'): the port refuses
`--tcnn --encoding frequency` when it builds the net, with that reason.

The sigma-net flatpack holds each layer's w.T (flattened) then b, in the
order of torch's state dict (:112-130), so a vector carries across the
packages bit for bit.
"""

import torch

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from .network import NeRFNetwork


def _mlp_bias(layers, h, dtype):
    """layers: {"w": [..., in, out], "b": [..., out]}; with a leading group
    axis on the weights, h is [G, ..., D]. Products of operands rounded to
    `dtype` with float32 sums, the float32 bias added after, ReLU between
    layers (network_tcnn.py:31-40)."""
    grouped = layers[0]["w"].ndim == 3
    shape = h.shape
    if grouped:
        h = h.reshape(shape[0], -1, shape[-1])
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        h = torch.matmul(h.to(dtype).float(), w.to(dtype).float())
        h = h + (b[:, None, :] if grouped else b).float()
        if i != len(layers) - 1:
            h = torch.relu(h)
    return h.reshape(shape[:-1] + (h.shape[-1],))


class NeRFNetworkTCNN(NeRFNetwork):
    """params: {"encoder": ... (a grid), "sigma_net": [{"w", "b"}, ...],
    "color_net": [...]}, or None for `init(generator)`; see
    NeRFNetwork."""

    mlp_bias = True

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 trainable: bool = False, generator=None):
        if cfg.bg_radius > 0:
            raise ValueError("network_tcnn has no background branch "
                             "(reference network_tcnn.py)")
        if cfg.fused and cfg.encoding == "frequency":
            raise AttributeError(
                "--tcnn --encoding frequency: the JAX package's "
                "NeRFNetworkTCNN sends a fused frequency-encoded net to the "
                "points kernel (network.py:274-285), whose "
                "fused_points_sigma_color reads the biased layers' shape "
                "and raises AttributeError: 'dict' object has no attribute "
                "'shape'")
        super().__init__(cfg, params, device=device, trainable=trainable,
                         generator=generator)

    def density(self, x, plain: bool = False):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}; no
        kernel (`plain` changes nothing)."""
        h = _mlp_bias(self.mlp("sigma_net"), self.encode_pos(x),
                      self.compute_dtype)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    def color(self, d, geo_feat, mask=None, plain: bool = False):
        """d: [..., 3], geo_feat [..., 15] -> rgb [..., 3]; the direction
        goes through tcnn's [0, 1] remap and back, as in the JAX class."""
        d01 = (d + 1.0) / 2.0
        d_enc = self.encode_dir(d01 * 2.0 - 1.0)
        h = torch.cat([d_enc, geo_feat.to(d_enc.dtype)], dim=-1)
        rgb = torch.sigmoid(_mlp_bias(self.mlp("color_net"), h,
                                      self.compute_dtype))
        if mask is not None:
            rgb = torch.where(mask[..., None], rgb, 0.0)
        return rgb

    # ------------------------------------------------ the sigma-net flatpack
    def get_sigma_net_flat(self):
        """Each layer's w.T flattened, then its b (network_tcnn.py:112-
        118), as one detached float32 vector."""
        return torch.cat([t for ly in self.mlp("sigma_net")
                          for t in (ly["w"].detach().t().reshape(-1),
                                    ly["b"].detach().reshape(-1))])

    def set_sigma_net_flat(self, theta):
        """{"w": [..., in, out], "b": [..., out]} views of theta [..., n],
        differentiable in theta (network_tcnn.py:120-130)."""
        layers, start = [], 0
        lead = theta.shape[:-1]
        for w in self.sigma_net:
            i, o = w.shape
            wv = theta[..., start:start + i * o].reshape(
                lead + (o, i)).transpose(-1, -2)
            start += i * o
            layers.append({"w": wv, "b": theta[..., start:start + o]})
            start += o
        if start != theta.shape[-1]:
            raise ValueError(f"theta has {theta.shape[-1]} entries, the "
                             f"sigma net {start}")
        return layers

    def sigma_of_encoding(self, h, sigma_ws):
        return trunc_exp(_mlp_bias(sigma_ws, h, self.compute_dtype)[..., 0])
