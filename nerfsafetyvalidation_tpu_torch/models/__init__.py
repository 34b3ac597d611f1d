"""NeRF field and frame renderer of the port."""

from .network import NeRFNetwork


def make_network(cfg, params, device="cuda"):
    """Backbone dispatch; the port has the frequency-encoded field only."""
    return NeRFNetwork(cfg, params, device=device)


__all__ = ["NeRFNetwork", "make_network"]
