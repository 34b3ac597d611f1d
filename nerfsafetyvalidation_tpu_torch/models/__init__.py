"""NeRF fields and frame renderer of the port."""

from .network import NeRFNetwork
from .network_ff import NeRFNetworkFF
from .network_mip import NeRFNetworkMip
from .network_tcnn import NeRFNetworkTCNN


def make_network(cfg, params, device="cuda", opt=None, **kw):
    """Backbone dispatch, in the JAX package's order (models/__init__.py:
    10-23): the mip-fold teacher (which also takes `trainable` and
    `generator`, see NeRFNetworkMip); with the CLI's options `opt`,
    `--tcnn` (`NeRFNetworkTCNN`) and `--ff` (`NeRFNetworkFF`); else
    `NeRFNetwork` for the frequency, hash-grid, tiled-grid and
    unencoded fields."""
    if cfg.encoding == "mipfold":
        return NeRFNetworkMip(cfg, params, device=device, **kw)
    if opt is not None and getattr(opt, "tcnn", False):
        return NeRFNetworkTCNN(cfg, params, device=device, **kw)
    if opt is not None and getattr(opt, "ff", False):
        return NeRFNetworkFF(cfg, params, device=device, **kw)
    return NeRFNetwork(cfg, params, device=device, **kw)


__all__ = ["NeRFNetwork", "NeRFNetworkFF", "NeRFNetworkMip",
           "NeRFNetworkTCNN", "make_network"]
