"""The fully-fused-MLP backbone that `--ff` builds: the port of the JAX
package's `NeRFNetworkFF` (nerfsafetyvalidation_tpu/models/network_ff.py).

The same hash-grid NeRF as `NeRFNetwork`, with the FFMLP topology of the
reference's network_ff.py: FFMLP's `num_layers` counts hidden layers, so
each net has one more hidden matmul (sigma 32 -> 64 -> 64 -> 16, color
32 -> 64 -> 64 -> 64 -> 3 at the default widths), and the color input
[SH16 | geo15] is padded with one zero column to 32. It always computes in
bfloat16 (`fused=True`), whatever the config says, as the JAX class forces
it. With a hash or tiled grid both MLPs run through kernel K4; with
`--encoding None` the sigma net is the plain chain (the JAX class inherits
`density`, fused only on a grid) and the color net still runs through K4
(its own `color` passes `fused=cfg.fused`, network_ff.py:56-67).

`init(generator)` draws every weight from a torch.Generator (uniform in
+-1/sqrt(in)); the JAX class splits its key 8 ways, so the draws differ
and parity runs through weights carried across (`assets.params_from_jax`).
"""

from dataclasses import replace

from ..config import NetworkConfig
from .network import NeRFNetwork, _widths


class NeRFNetworkFF(NeRFNetwork):
    color_pad = 1       # [SH16 | geo15] -> 32 columns (network_ff.py:42)

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 trainable: bool = False, generator=None):
        if cfg.bg_radius > 0:
            raise AssertionError("background model is not implemented for "
                                 "--ff")
        if cfg.encoding == "frequency":
            # the JAX class's apply feeds a frequency encoding to K1, which
            # takes a 31-wide color input, and raises on the 32-wide net
            raise NotImplementedError("--ff builds a grid net or one "
                                      "without an encoding, not frequency")
        super().__init__(replace(cfg, fused=True, compute_dtype="bfloat16"),
                         params, device=device, trainable=trainable,
                         generator=generator)

    @property
    def _color_fused(self):
        return self.cfg.fused

    def _sigma_shapes(self):
        cfg = self.cfg
        return _widths(self.in_dim, cfg.hidden_dim, 3, 1 + cfg.geo_feat_dim)

    def _color_shapes(self):
        cfg = self.cfg
        return _widths(self.in_dim_dir + cfg.geo_feat_dim + self.color_pad,
                       cfg.hidden_dim_color, 4, 3)
