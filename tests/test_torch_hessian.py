"""The port's Hessian approximations (nerfsafetyvalidation_tpu_torch/uq/
hessian.py, hessian_toy.py) against the JAX package's on the CPU.

Every method on the toy quadratic and on a non-quadratic function
(a Rosenbrock chain plus a cosine); the toy's results table; L-BFGS over
its first steps (the iterates of optax.lbfgs, driven as the JAX package
drives it) and at its converged iterate; Levenberg-Marquardt over a few
steps, and its branch for a non-finite solve; and that the port's
regressions run without sklearn, which the card's machine lacks."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfsafetyvalidation_tpu.uq import hessian as JH
from nerfsafetyvalidation_tpu.uq import hessian_toy as JToy
from nerfsafetyvalidation_tpu_torch.uq import hessian as TH
from nerfsafetyvalidation_tpu_torch.uq import hessian_toy as TToy

torch.set_num_threads(1)

A = np.asarray([[3.0, 1.0, 0.0], [1.0, 2.0, 0.5], [0.0, 0.5, 4.0]],
               np.float32)
X_TOY = np.float32([1.0, -1.0, 0.5])
X_ROSEN = np.float32([-1.2, 1.0, 0.5, -0.3])


def quad_j(x):
    return 0.5 * x @ jnp.asarray(A) @ x


def quad_t(x):
    return 0.5 * x @ torch.from_numpy(A) @ x


def rosen_j(x):
    return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2) \
        + 0.1 * jnp.sum(jnp.cos(x))


def rosen_t(x):
    return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2) \
        + 0.1 * torch.sum(torch.cos(x))


FUNCS = {"quadratic": (quad_j, quad_t, X_TOY),
         "rosenbrock": (rosen_j, rosen_t, X_ROSEN)}
# methods whose arithmetic is the JAX package's step for step: float32
# gradients of the same expressions (finite differences and the
# regressions read them through float32 sums); the bound is a few float32
# roundings of the largest entry
EXACT = ("finite_difference", "autodiff", "regression_gradient",
         "regression_gradient_regularized")
RTOL = 1e-5


def _j(method, f, x, **kw):
    return np.asarray(JH.HessianApproximator(f, method, **kw).compute(
        jnp.asarray(x)))


def _t(method, f, x, **kw):
    return TH.HessianApproximator(f, method, **kw).compute(
        torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("method", EXACT)
@pytest.mark.parametrize("func", sorted(FUNCS))
def test_methods_match_jax(method, func):
    """Each method at the JAX toy's settings (epsilon 1e-3 for finite
    differences, delta 1e-2 for the regressions, alpha 0.1)."""
    fj, ft, x = FUNCS[func]
    kw = dict(epsilon=1e-3, delta=1e-2)
    want, got = _j(method, fj, x, **kw), _t(method, ft, x, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_default_finite_difference_rows_vanish():
    """At the default epsilon 1e-8, x + eps rounds to x in float32 where
    |x| >= 0.125: those rows are 0 in both packages."""
    want, got = _j("finite_difference", rosen_j, X_ROSEN), \
        _t("finite_difference", rosen_t, X_ROSEN)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_toy_table_matches_jax():
    """hessian_toy's table: the same keys, each error within 1e-6 of
    JAX's (the LM row, a least eigenvalue of g g^T, is 0 up to float32
    rounding in both)."""
    want = JToy.run_toy_example(verbose=False)
    got = TToy.run_toy_example(verbose=False)
    assert list(got) == list(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(
            1.0, abs(float(want[k]))), (k, got[k], want[k])


def test_toy_prints_its_table(capsys):
    TToy.run_toy_example(verbose=True)
    out = capsys.readouterr().out
    assert "exact Hessian" in out and "levenberg_marquardt" in out


def test_lbfgs_first_steps_match_optax():
    """The first 6 L-BFGS steps on the Rosenbrock chain: the port's
    iterates against optax.lbfgs(learning_rate=1.0) driven as the JAX
    package's `lbfgs` drives it (value and gradient at x, update with
    value_fn, x + update), within 1e-4 of the iterate's scale (float32
    line-search scalars in another order of operations)."""
    xj = jnp.asarray(X_ROSEN)
    opt = optax.lbfgs(learning_rate=1.0)
    state = opt.init(xj)
    vg = jax.value_and_grad(rosen_j)
    xt = torch.from_numpy(X_ROSEN)
    port = TH.LBFGS(xt, 1.0)

    def vg_t(p):
        return TH._value_and_grad(rosen_t, p)

    for k in range(6):
        value, grad = vg(xj)
        upd, state = opt.update(grad, state, xj, value=value, grad=grad,
                                value_fn=rosen_j)
        xj = xj + upd
        v_t, g_t = vg_t(xt)
        xt = xt + port.update(xt, v_t, g_t, vg_t)
        want = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"step {k}")


def smooth_j(x):
    return quad_j(x) + jnp.log(jnp.sum(jnp.exp(2 * x))) \
        + 0.25 * jnp.sum(x ** 4)


def smooth_t(x):
    return quad_t(x) + torch.log(torch.sum(torch.exp(2 * x))) \
        + 0.25 * torch.sum(x ** 4)


def test_lbfgs_hessian_at_its_iterate():
    """The autodiff Hessian where each package's L-BFGS stops (its iterate
    allclose to the last) on the toy quadratic plus a log-sum-exp and a
    quartic: within 1e-5 of the largest entry."""
    want = _j("lbfgs", smooth_j, X_TOY)
    got = _t("lbfgs", smooth_t, X_TOY)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("func,steps", [("quadratic", 3),
                                        ("rosenbrock", 1)])
def test_levenberg_marquardt_few_steps(func, steps):
    """LM against JAX's. Its dense solves of g g^T + lmbda I in float32
    are ill-conditioned by |g|^2 / lmbda (1e7 on the Rosenbrock chain's
    start), so two LAPACK solves part at the float32 noise of the solution
    (1% of its first step there) and the iterates wander apart, in either
    package: on the toy quadratic (|g|^2 ~ 10) over 3 steps, on the
    Rosenbrock chain over its first step, the returned g g^T agrees within
    1e-2 of its largest entry."""
    fj, ft, x = FUNCS[func]
    want = np.asarray(JH.levenberg_marquardt(jnp.asarray(x), fj,
                                             max_iter=steps))
    got = TH.levenberg_marquardt(torch.from_numpy(x), ft,
                                 max_iter=steps).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_levenberg_marquardt_non_finite_solves():
    """A gradient that is NaN makes every solve non-finite: lmbda grows
    and no step is kept, so both return g g^T at x0 (all NaN)."""
    def fj(x):
        return jnp.sum(jnp.sqrt(x))

    def ft(x):
        return torch.sum(torch.sqrt(x))
    x = np.float32([-1.0, 2.0])
    want = np.asarray(JH.levenberg_marquardt(jnp.asarray(x), fj,
                                             max_iter=4))
    got = TH.levenberg_marquardt(torch.from_numpy(x), ft, max_iter=4).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1, 1], want[1, 1], rtol=1e-6)


def test_levenberg_marquardt_singular_solves():
    """lmbda 0 and a gradient with an exact zero: g g^T has a zero row,
    JAX's solve returns non-finite values (it never raises) and the
    port's reports the zero pivot; both keep no step and return g g^T at
    x0."""
    def fj(x):
        return x[0] ** 2

    def ft(x):
        return x[0] ** 2
    x = np.float32([1.5, 2.0])
    want = np.asarray(JH.levenberg_marquardt(jnp.asarray(x), fj, lmbda=0.0,
                                             max_iter=3))
    got = TH.levenberg_marquardt(torch.from_numpy(x), ft, lmbda=0.0,
                                 max_iter=3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 9.0


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        TH.HessianApproximator(quad_t, "nope").compute(torch.zeros(3))


def test_regressions_need_no_sklearn():
    """The toy, regressions included, runs with sklearn made unimportable,
    and the port's UQ never imports it."""
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "from nerfsafetyvalidation_tpu_torch.uq import hessian_toy\n"
            "import nerfsafetyvalidation_tpu_torch.uq as uq\n"
            "r = hessian_toy.run_toy_example(verbose=False)\n"
            "assert all(k in r for k in ('regression_gradient(delta=0.01)',"
            " 'regression_regularized(alpha=1)'))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
