"""Row-by-row Jacobians and Hessians by reverse mode, for functions whose
leading dimensions are independent problems (a population of sims, or one
state). The JAX package takes them with `jax.jacfwd` and `jax.hessian`
(nav/estimator.py, validation/closed_loop.py); the derivatives are the
same.

Because the problems do not interact, one backward of the summed output i
gives row i of every problem's Jacobian, and one double-backward of the
summed gradient entry k gives row k of every problem's Hessian."""

import torch


def jacobian_rows(fn, x):
    """fn: [..., n] -> [..., m], each leading index on its own. Returns the
    Jacobians [..., m, n] at x (m backward passes)."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        out = fn(leaf)
        m = out.shape[-1]
        rows = [torch.autograd.grad(out[..., i].sum(), leaf,
                                    retain_graph=i < m - 1)[0]
                for i in range(m)]
    return torch.stack(rows, dim=-2)


def hessian_rows(loss_fn, x):
    """loss_fn: [..., n] -> a scalar, the sum of independent problems'
    losses. Returns each problem's Hessian [..., n, n] at x (one gradient
    with its graph, then n double-backward passes)."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        grad, = torch.autograd.grad(loss_fn(leaf), leaf, create_graph=True)
        n = grad.shape[-1]
        rows = [torch.autograd.grad(grad[..., k].sum(), leaf,
                                    retain_graph=k < n - 1)[0]
                for k in range(n)]
    return torch.stack(rows, dim=-2)
