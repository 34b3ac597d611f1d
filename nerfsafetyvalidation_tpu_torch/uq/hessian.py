"""Hessian approximations (nerfsafetyvalidation_tpu/uq/hessian.py; reference
uncertainty/quantification/hessian/{HessianApproximator,methods}.py).

Every method takes `func`, a function of a float32 vector x [n] (a tensor)
to a scalar tensor, differentiable by autograd, and returns an [n, n]
float32 tensor on x's device:

  * finite_difference: row i = (grad(x + eps e_i) - grad(x)) / eps, in
    float32 (methods.py:7-43);
  * autodiff: the exact Hessian, one double-backward a row
    (utils/autodiff.hessian_rows; the JAX package takes jax.hessian);
  * lbfgs: up to 20 steps of optax's `lbfgs` (memory 10, its initial
    preconditioner scaling, its zoom line search), written out below, then
    the autodiff Hessian at the iterate (methods.py:45-77);
  * regression_gradient / regression_gradient_regularized: least squares
    of f(x + d) - f(x) on [d, 0.5 d d^T] over 200 draws of d from numpy's
    default_rng(0), sklearn's LinearRegression() and Ridge(alpha) with their
    fitted intercept written out in numpy/scipy (methods.py:79-156);
  * levenberg_marquardt: the LM iteration on host control flow, returning
    the gradient outer product g g^T at the last step whose solve was
    finite (methods.py:158-188), the production Laplace path's Hessian.
"""

import numpy as np
import scipy.linalg
import torch

from ..utils.autodiff import hessian_rows


def _value_and_grad(func, x):
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        value = func(leaf)
        grad, = torch.autograd.grad(value, leaf)
    return value.detach(), grad


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def finite_difference(x, func, epsilon=1e-8):
    """Row-wise finite differences of the gradient, in float32: with the
    default epsilon, x + eps rounds to x wherever |x| > ~0.1, and those
    rows are 0, as in the JAX package."""
    x = _f32(x)
    g0 = _value_and_grad(func, x)[1].cpu().numpy()
    n = x.numel()
    hessian = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        xi = x.clone()
        xi[i] += epsilon
        gi = _value_and_grad(func, xi)[1].cpu().numpy()
        hessian[i] = (gi - g0) / np.float32(epsilon)
    return torch.from_numpy(hessian).to(x.device)


def autodiff_hessian(x, func):
    """The exact Hessian by double backward."""
    return hessian_rows(func, _f32(x))


# -------------------------------------------------------- optax's L-BFGS
F32 = np.float32


def _dot(a, b):
    return F32(torch.sum(a * b).item())


class _ZoomLinesearch:
    """optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one") with its other defaults (tol 0, increase
    factor 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, interval
    threshold 1e-5, no largest step): the strong-Wolfe search of a step
    along a descent direction, scalars in float32."""

    max_steps, increase, slope_rtol, curv_rtol = 20, F32(2.0), 1e-4, 0.9
    approx_rtol, threshold = 1e-6, 1e-5

    def __init__(self, value_and_grad_fn, x, u, value, grad):
        self.vg, self.x, self.u = value_and_grad_fn, x, u
        slope = _dot(u, grad)
        self.value_init, self.slope_init = F32(value), slope
        s = self.__dict__
        s.update(count=0, stepsize=F32(0.0), value=F32(value), grad=grad,
                 slope=slope, decrease_error=F32(np.inf),
                 interval_found=False, done=False, failed=False,
                 low=F32(0.0), value_low=F32(value), slope_low=slope,
                 high=F32(0.0), value_high=F32(value), slope_high=slope,
                 cubic_ref=F32(0.0), value_cubic_ref=F32(value),
                 safe_stepsize=F32(0.0), safe_value=F32(value),
                 safe_grad=grad)

    def _on_line(self, stepsize):
        value, grad = self.vg(self.x + float(stepsize) * self.u)
        return F32(value.item()), grad, _dot(grad, self.u)

    def _decrease_error(self, stepsize, value, slope):
        v0, s0 = self.value_init, self.slope_init
        err = value - v0 - F32(self.slope_rtol) * stepsize * s0
        approx = slope - F32(2 * self.slope_rtol - 1.0) * s0
        approx = max(approx, value - v0 - F32(self.approx_rtol) * abs(v0))
        err = max(min(approx, err), F32(0.0))
        return F32(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope):
        err = max(abs(slope) - F32(self.curv_rtol) * abs(self.slope_init),
                  F32(0.0))
        return F32(np.inf) if np.isnan(err) else err

    def _search_interval(self):
        prev = (self.stepsize, self.value, self.slope)
        step = F32(1.0) if self.count == 0 else self.increase * self.stepsize
        value, grad, slope = self._on_line(step)
        dec = self._decrease_error(step, value, slope)
        err = max(dec, self._curvature_error(slope))
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = \
                step, value, grad
        high_new = dec > 0.0 or (value >= prev[1] and self.count > 0)
        low_new = slope >= 0.0 and not high_new
        new = (step, value, slope)
        lo, hi = (new, prev) if low_new else (prev, new)
        (self.low, self.value_low, self.slope_low), \
            (self.high, self.value_high, self.slope_high) = lo, hi
        self.interval_found = high_new or low_new or err <= 0.0
        self.done = bool(err <= 0.0)
        self.failed = self.count + 1 >= self.max_steps and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = new[0], value, \
            grad, slope
        self.decrease_error = dec

    def _zoom_into_interval(self):
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
        too_small = delta <= self.threshold
        mc = _cubicmin(low, self.value_low, self.slope_low, high,
                       self.value_high, self.cubic_ref, self.value_cubic_ref)
        use_cubic = bool(left + cubic_chk < mc < right - cubic_chk)
        mq = _quadmin(low, self.value_low, self.slope_low, high,
                      self.value_high)
        use_quad = not use_cubic and bool(left + quad_chk < mq
                                          < right - quad_chk)
        middle = mc if use_cubic else mq if use_quad \
            else (low + high) / F32(2.0)
        value, grad, slope = self._on_line(middle)
        dec = self._decrease_error(middle, value, slope)
        err = max(dec, self._curvature_error(slope))
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = \
                middle, value, grad
        self.done = bool(err <= 0.0)
        high_mid = dec > 0.0 or value >= self.value_low
        high_low = slope * (high - low) >= 0.0 and not high_mid
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high, self.slope_high)
        mid = (middle, value, slope)
        new_high = old_low if high_low else mid if high_mid else old_high
        new_low = old_low if high_mid else mid
        self.cubic_ref, self.value_cubic_ref = \
            old_high[:2] if high_mid or high_low else old_low[:2]
        (self.low, self.value_low, self.slope_low) = new_low
        (self.high, self.value_high, self.slope_high) = new_high
        failed = (self.count + 1 >= self.max_steps
                  or (too_small and self.safe_stepsize > 0.0))
        self.failed = failed and not self.done
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = mid[0], value, \
            grad, slope
        self.decrease_error = dec

    def run(self):
        """The accepted step size."""
        with np.errstate(all="ignore"):
            while not (self.done or self.failed):
                if self.interval_found:
                    self._zoom_into_interval()
                else:
                    self._search_interval()
                if self.failed and (self.safe_stepsize > 0.0
                                    or np.isinf(self.decrease_error)):
                    self.stepsize = self.safe_stepsize
        return self.stepsize


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's cubic interpolation (NaN where the radical is negative)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    radical = B * B - F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (F32(2.0) * B)


class LBFGS:
    """optax.lbfgs(learning_rate=lr): scale_by_lbfgs(memory_size=10,
    scale_init_precond=True), then the step -lr times the preconditioned
    gradient, then the zoom line search along it. `update(x, value, grad,
    value_and_grad_fn)` -> the update to add to x."""

    def __init__(self, x, lr=1.0, memory_size=10):
        self.lr, self.m = F32(lr), memory_size
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dp = torch.zeros((memory_size,) + x.shape, dtype=x.dtype,
                              device=x.device)
        self.du = torch.zeros_like(self.dp)
        self.w = np.zeros(memory_size, dtype=np.float32)

    def _precondition(self, grad, x):
        m, k = self.m, self.count
        idx, prev = k % m, (k - 1) % m
        dp, du = x - self.params, grad - self.updates
        vdot = _dot(du, dp)
        weight = F32(0.0) if vdot == 0.0 else F32(1.0) / vdot
        if k == 0:
            dp, du, weight = torch.zeros_like(dp), torch.zeros_like(du), \
                F32(0.0)
        self.dp[prev], self.du[prev], self.w[prev] = dp, du, weight
        if k > 0:
            den = _dot(du, du)
            scale = _dot(du, dp) / den if den > 0.0 else F32(1.0)
        else:
            scale = min(F32(1.0), F32(1.0) / F32(np.sqrt(_dot(grad, grad))))
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self.w[i] * _dot(self.dp[i], vec)
            vec = vec + float(-alphas[i]) * self.du[i]
        vec = float(scale) * vec
        for i in order:
            beta = self.w[i] * _dot(self.du[i], vec)
            vec = vec + float(alphas[i] - beta) * self.dp[i]
        self.count, self.params, self.updates = k + 1, x, grad
        return vec

    def update(self, x, value, grad, value_and_grad_fn):
        with np.errstate(all="ignore"):
            u = float(-self.lr) * self._precondition(grad, x)
        step = _ZoomLinesearch(value_and_grad_fn, x, u, value.item(),
                               grad).run()
        return float(step) * u


def lbfgs(x, func, max_iter=20, lr=1.0):
    """Up to max_iter L-BFGS steps from x (stopping at a non-finite
    gradient or iterate, or where the iterate is allclose to the last one,
    rtol 1e-5 / atol 1e-10), then the autodiff Hessian there."""
    x = _f32(x)
    opt = LBFGS(x, lr)

    def vg(p):
        return _value_and_grad(func, p)

    for _ in range(max_iter):
        value, grad = vg(x)
        if not bool(torch.isfinite(grad).all()):
            break
        x_new = x + opt.update(x, value, grad, vg)
        if not bool(torch.isfinite(x_new).all()):
            break
        if torch.allclose(x_new, x, rtol=1e-5, atol=1e-10):
            x = x_new
            break
        x = x_new
    return autodiff_hessian(x, func)


# ---------------------------------------------------------- regressions
def _linear_regression(X, y):
    """sklearn's LinearRegression().fit(X, y).coef_: X and y centred on
    their means (the fitted intercept), then scipy's least squares with
    singular values under 1e-6 of the largest cut (its `tol`)."""
    Xc, yc = X - X.mean(axis=0), y - y.mean()
    return scipy.linalg.lstsq(Xc, yc, cond=1e-6)[0]


def _ridge(X, y, alpha):
    """sklearn's Ridge(alpha).fit(X, y).coef_ (dense X: its Cholesky
    solver): centred as above, then (X^T X + alpha I) coef = X^T y, or the
    kernel form X^T (X X^T + alpha I)^-1 y when features outnumber
    samples."""
    Xc, yc = X - X.mean(axis=0), y - y.mean()
    n_samples, n_features = Xc.shape
    if n_features > n_samples:
        K = Xc @ Xc.T
        K.flat[::n_samples + 1] += alpha
        return Xc.T @ scipy.linalg.solve(K, yc, assume_a="pos")
    A = Xc.T @ Xc
    A.flat[::n_features + 1] += alpha
    return scipy.linalg.solve(A, Xc.T @ yc, assume_a="pos")


def regression_gradient(theta, func, perturbations=200, delta=1e-6):
    """The Hessian from a linear regression on random perturbations
    (methods.py:79-116)."""
    return _regression(theta, func, perturbations, delta, _linear_regression)


def regression_gradient_regularized(theta, func, perturbations=200,
                                    delta=1e-6, alpha=0.1):
    """The same with a ridge regression (methods.py:118-156)."""
    return _regression(theta, func, perturbations, delta,
                       lambda X, y: _ridge(X, y, alpha))


def _regression(theta, func, perturbations, delta, fit):
    device = theta.device if torch.is_tensor(theta) else "cpu"
    theta = np.asarray(torch.as_tensor(theta).cpu(), dtype=np.float64)
    n = theta.size

    def f(t):
        with torch.no_grad():
            return float(func(torch.as_tensor(t, dtype=torch.float32,
                                              device=device)).sum())

    rng = np.random.default_rng(0)
    delta_theta = np.zeros((perturbations, n))
    delta_u = np.zeros(perturbations)
    f0 = f(theta)
    for i in range(perturbations):
        delta_theta[i] = delta * rng.standard_normal(n)
        delta_u[i] = f(theta + delta_theta[i]) - f0
    # the quadratic design of methods.py:105
    quad = 0.5 * np.einsum("pi,pj->pij", delta_theta,
                           delta_theta).reshape(perturbations, -1)
    coef = fit(np.hstack([delta_theta, quad]), delta_u)
    elements = coef[n:]
    hessian = np.zeros((n, n))
    # the reference's triangular index map (methods.py:113)
    for i in range(n):
        for j in range(i, n):
            index = int(n * i - i * (i - 1) / 2 + j)
            if index < elements.size:
                hessian[i, j] = hessian[j, i] = elements[index]
    return torch.as_tensor(hessian, dtype=torch.float32, device=device)


# ------------------------------------------------------ Levenberg-Marquardt
def levenberg_marquardt(x0, func, lmbda=0.01, max_iter=200):
    """The LM iteration (methods.py:158-188): dx solves (g g^T + lmbda I)
    dx = -g, a dense solve on x's device that does not raise (jnp.linalg.
    solve never does: a zero pivot gives inf or NaN there, and a reported
    one counts as such here); a non-finite dx multiplies lmbda by 10 and
    retries; otherwise H = g g^T is kept, the loop ends where dx
    is allclose to 0 (rtol 1e-5, atol 1e-8), x moves by dx, and lmbda is
    divided by 10 where f(x) < f(x0) (the start's value, not the last
    accepted one) and multiplied by 10 elsewhere. Returns the last kept
    H (g g^T at x0 if none)."""
    x0 = _f32(x0)

    def grad_fn(p):
        return _value_and_grad(func, p)

    def value_fn(p):
        with torch.no_grad():
            return func(p)
    x, n = x0, x0.numel()
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    hessian = None
    f_x0 = value_fn(x0)
    for _ in range(max_iter):
        g = grad_fn(x)[1]
        H = torch.outer(g, g)
        dx, info = torch.linalg.solve_ex(H + lmbda * eye, -g)
        if int(info) != 0 or not bool(torch.isfinite(dx).all()):
            lmbda *= 10
            continue
        hessian = H
        if torch.allclose(dx, torch.zeros_like(dx)):
            break
        x = x + dx
        if bool(value_fn(x) < f_x0):
            lmbda /= 10
        else:
            lmbda *= 10
    if hessian is None:
        g = grad_fn(x0)[1]
        hessian = torch.outer(g, g)
    return hessian


class HessianApproximator:
    """Strategy dispatcher (HessianApproximator.py:4-40)."""

    def __init__(self, func, method="finite_difference", epsilon=1e-8,
                 delta=1e-6, alpha=0.1, lmbda=0.01):
        self.func = func
        self.method = method
        self.epsilon = epsilon
        self.delta = delta
        self.alpha = alpha
        self.lmbda = lmbda

    def compute(self, x):
        if self.method == "finite_difference":
            return finite_difference(x, self.func, self.epsilon)
        if self.method == "autodiff":
            return autodiff_hessian(x, self.func)
        if self.method in ("bfgs", "lbfgs"):
            return lbfgs(x, self.func)
        if self.method == "regression_gradient":
            return regression_gradient(x, self.func, delta=self.delta)
        if self.method == "regression_gradient_regularized":
            return regression_gradient_regularized(x, self.func,
                                                   delta=self.delta,
                                                   alpha=self.alpha)
        if self.method == "levenberg_marquardt":
            return levenberg_marquardt(x, self.func, lmbda=self.lmbda)
        raise ValueError(f"unknown Hessian method {self.method!r}")
