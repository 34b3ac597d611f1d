"""NeRF fields and frame renderer of the port."""

from .network import NeRFNetwork
from .network_mip import NeRFNetworkMip


def make_network(cfg, params, device="cuda", **kw):
    """Backbone dispatch: the mip-fold teacher (which also takes
    `trainable` and `generator`, see NeRFNetworkMip), or `NeRFNetwork` for
    the frequency and hash-grid fields."""
    if cfg.encoding == "mipfold":
        return NeRFNetworkMip(cfg, params, device=device, **kw)
    return NeRFNetwork(cfg, params, device=device, **kw)


__all__ = ["NeRFNetwork", "NeRFNetworkMip", "make_network"]
