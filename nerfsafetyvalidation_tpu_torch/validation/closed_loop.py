"""The closed-loop batched rollout engine (nerfsafetyvalidation_tpu/
validation/closed_loop.py): a population of filtered-MPC simulations
stepped together. Per sim and step:

  1. the action is the first of the sim's current plan (`calc_everything`
     from its last estimate);
  2. the true state moves through the disturbed dynamics;
  3. the measurement target is rendered at the true pose along the
     estimator's observation chain at a fixed set of interest pixels
     ("pixels"), or as the whole obs_hw frame gathered at those pixels
     ("frame"), quantized to 8 bits as a camera's image is;
  4. the estimator: the dynamics-propagated mean, its 12x12 Jacobian's
     covariance propagation, n_iter Adam steps on the photometric plus
     Mahalanobis loss, and the posterior covariance, the inverse Hessian
     of that loss at the optimum;
  5. the planner: the fixed-horizon knot shift and epochs_update Adam
     steps on the planner's cost from a fresh optimizer;
  6. the 4-point interpolated SDF check, which freezes a collided sim;
  7. with a `uq_engine` (a FullBatchedRolloutEngine), the observation's
     UQ (the engine's: Gaussian, or Laplace, its fits' draws from a
     generator seeded 0 at each run) and the safety-masked reward.

The JAX package maps a scan of this step over the population with `vmap`
and differentiates with `jax.grad`, `jax.jacfwd` and `jax.hessian`. Here the
steps, the Adam iterations and the replan epochs are Python loops over
tensors of the whole population: one render of every sim's pixels an
iteration, one density query of every sim's body points an epoch. Sims do
not interact, so the gradient of the population's summed loss is each
sim's gradient, and 12 double-backward products give every sim's 12x12
Hessian (the Hessian of the sum is block-diagonal); the dynamics' 12x12
Jacobian comes from 12 backward passes the same way (utils/autodiff.py,
which the sequential estimator shares; JAX takes the Jacobian in forward
mode, the derivative is the same).

`sim_group` runs at most that many sims at a time. The render runs through
the net's own chain (with `--ff`, K4, whose backward is a recompute of
its plain chain; the JAX CLI cannot take the estimator's Hessian through
K4, and the port's validate refuses that combination). `mesh` (sharding
over devices) waits for slice G and raises."""

import math

import numpy as np
import torch

from ..data.rays import get_rays, rays_for_pixels
from ..nav.agent import drone_dynamics
from ..nav.math_utils import (as_f32, mahalanobis, nerf_matrix_to_ngp, rot_x,
                              vec_to_rot_matrix)
from ..nav.planner import calc_everything, planner_cost_terms
from ..utils.adam import Adam
from ..utils.autodiff import hessian_rows, jacobian_rows
from .batched import BatchedRolloutEngine, _cem_proposal_update, _no_mesh

# rays a call when the "frame" target renders a whole observation
FRAME_CHUNK = 65536


def _finite_risks(risks):
    """A rollout that escapes the workspace gives non-finite states and a
    non-finite risk; it becomes +inf, the least interesting risk, so that
    it never enters CEM's elite set."""
    risks = np.asarray(risks, dtype=np.float64)
    return np.where(np.isfinite(risks), risks, np.inf)


def state12_to_18(x):
    """[..., 12] (rotation vector) -> [..., 18] (rotation matrix)."""
    R = vec_to_rot_matrix(x[..., 6:9]).reshape(x.shape[:-1] + (9,))
    return torch.cat([x[..., :6], R, x[..., 9:]], dim=-1)


class ClosedLoopBatchedEngine(BatchedRolloutEngine):
    def __init__(self, *, steps, dt, g, mass, I, sdf, sdf_start, granularity,
                 noise_mean, noise_std, start_state,
                 fixed_coords, intrinsics, obs_hw, render_rays_fn,
                 n_iter=20, est_lr=1e-3, sig0=None, Q=None, filter=True,
                 end_state, knots0, initial_accel0, epochs_update=2,
                 planner_lr=1e-3, density_fn, robot_body,
                 fade_out_epoch=0, fade_out_sharpness=10.0,
                 quantize_target=True, obs_render="pixels", mesh=None,
                 uq_engine=None, sim_group=None, device="cuda"):
        """start_state [12] (rotation vector), end_state [18], the plan's
        knots0 [S, 4] and initial_accel0 [2] (after `Planner.a_star_init`
        and `learn_init`), fixed_coords [B, 2] (row, col) interest pixels of
        the obs_hw (H, W) camera with intrinsics (fx, fy, cx, cy);
        render_rays_fn(rays_o [1, N, 3], rays_d [1, N, 3]) -> {'image':
        [1, N, 3]}, differentiable in the rays; density_fn [..., 3] ->
        [...], differentiable in the points; robot_body [B', 3]; uq_engine:
        an optional FullBatchedRolloutEngine (Gaussian UQ) whose
        observation and reward every step also computes. The arrays may be
        numpy or tensors; they live on `device`."""
        _no_mesh(mesh)
        dev = torch.device(device)
        self.fixed_coords = torch.as_tensor(np.asarray(fixed_coords),
                                            dtype=torch.int64, device=dev)
        self.intrinsics = tuple(float(v) for v in intrinsics)
        self.obs_hw = (int(obs_hw[0]), int(obs_hw[1]))
        self.render_rays_fn = render_rays_fn
        self.n_iter = int(n_iter)
        self.est_lr = float(est_lr)
        self.sig0 = torch.eye(12, device=dev) if sig0 is None \
            else as_f32(sig0, dev)
        self.Q = torch.eye(12, device=dev) if Q is None else as_f32(Q, dev)
        self.filter = bool(filter)
        self.end_state18 = as_f32(end_state, dev)
        self.knots0 = as_f32(knots0, dev)
        self.initial_accel0 = as_f32(initial_accel0, dev)
        self.epochs_update = int(epochs_update)
        self.planner_lr = float(planner_lr)
        self.density_fn = density_fn
        self.robot_body = as_f32(robot_body, dev)
        self.fade_out_epoch = float(fade_out_epoch)
        self.fade_out_sharpness = float(fade_out_sharpness)
        self.quantize_target = bool(quantize_target)
        if obs_render not in ("pixels", "frame"):
            raise ValueError(f"unknown obs_render {obs_render!r}")
        self.obs_render = obs_render
        self.sim_group = None if sim_group is None else int(sim_group)
        self.uq_engine = uq_engine
        super().__init__(torch.zeros((int(steps), 4)), dt, g, mass, I, sdf,
                         sdf_start, granularity, noise_mean, noise_std,
                         start_state, device=dev)
        self.g_vec = torch.tensor([0.0, 0.0, -self.g], device=dev)

    # ------------------------------------------------------------- rendering
    def _obs_pose(self, states):
        """[m, 12] -> [m, 4, 4]: the camera at the state along the
        estimator's render_from_pose chain, rot_x(pi/2) @ R then the NGP
        remap."""
        R = rot_x(math.pi / 2, self.device) @ vec_to_rot_matrix(
            states[:, 6:9])
        p, t = nerf_matrix_to_ngp(R, states[:, :3])
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
        top = torch.cat([p, t[..., None]], dim=-1)
        return torch.cat([top, bottom.expand(states.shape[0], 1, 4)], dim=1)

    def _pixel_rays(self, states):
        """The interest pixels' rays of every state, [m * B, 3] each."""
        rays = [rays_for_pixels(pose, self.intrinsics, self.fixed_coords)
                for pose in self._obs_pose(states)]
        return (torch.cat([o for o, _ in rays]),
                torch.cat([d for _, d in rays]))

    def _render(self, rays_o, rays_d):
        return self.render_rays_fn(rays_o[None], rays_d[None])["image"][0]

    def _quantize(self, img):
        if self.quantize_target:
            return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0) / 255.0
        return img

    @torch.no_grad()
    def _target_pixels(self, states):
        """The measurement targets [m, B, 3] at the true states: the
        interest pixels' rays alone ("pixels"), or each sim's whole frame,
        quantized, gathered at the pixels ("frame")."""
        m, B = states.shape[0], self.fixed_coords.shape[0]
        if self.obs_render == "frame":
            H, W = self.obs_hw
            rays = get_rays(self._obs_pose(states), self.intrinsics, H, W,
                            device=self.device)
            flat = self.fixed_coords[:, 0] * W + self.fixed_coords[:, 1]
            out = []
            for ro, rd in zip(rays["rays_o"], rays["rays_d"]):
                img = torch.cat([self._render(ro[i:i + FRAME_CHUNK],
                                              rd[i:i + FRAME_CHUNK])
                                 for i in range(0, H * W, FRAME_CHUNK)])
                out.append(self._quantize(img)[flat])
            return torch.stack(out)
        img = self._render(*self._pixel_rays(states))
        return self._quantize(img.reshape(m, B, 3))

    # -------------------------------------------------------------- estimate
    def _dynamics(self, states, action):
        return drone_dynamics(states, action, self.dt, self.g, self.mass,
                              self.I, self.invI)

    def _estimate(self, xt, sig, action, target):
        """Propagate, n_iter Adam steps, the posterior: states xt [m, 12],
        covariances sig [m, 12, 12], actions [m, 4], targets [m, B, 3] ->
        (estimates [m, 12], covariances [m, 12, 12])."""
        m = xt.shape[0]
        with torch.no_grad():
            xt_prop = self._dynamics(xt, action)
        # the Jacobian at the propagated state, as the sequential estimator
        # takes it: row i of every sim's from one backward of output i
        A = jacobian_rows(lambda x: self._dynamics(x, action), xt_prop)
        with torch.no_grad():
            sig_prop = A @ sig @ A.transpose(-1, -2) + self.Q

        def loss(s):
            """The population's summed measurement loss."""
            rgb = self._render(*self._pixel_rays(s)).reshape(m, -1, 3)
            photo = torch.mean((rgb - target) ** 2, dim=(-2, -1))
            return torch.sum(photo + mahalanobis(s, xt_prop, sig_prop))

        s = xt_prop + 1e-6
        adam = Adam([s], self.est_lr)
        for _ in range(self.n_iter):
            with torch.enable_grad():
                leaf = s.detach().requires_grad_(True)
                grad, = torch.autograd.grad(loss(leaf), leaf)
            s, = adam.step([s], [grad])
        if not self.filter:
            return s, sig_prop
        return s, torch.linalg.inv(hessian_rows(loss, s))

    def _replan(self, knots, ia, start18):
        """epochs_update Adam steps from a fresh optimizer on every sim's
        mean planner cost (knots [m, S, 4], ia [m, 2], start18 [m, 18])."""
        params = [knots, ia]
        adam = Adam(params, self.planner_lr)
        for epoch in range(self.epochs_update):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True) for p in params]
                total, _ = planner_cost_terms(
                    leaves[0], leaves[1], start18, self.end_state18, epoch,
                    density_fn=self.density_fn, dt=self.dt, g_vec=self.g_vec,
                    J=self.I, mass=self.mass, robot_body=self.robot_body,
                    fade_out_epoch=self.fade_out_epoch,
                    fade_out_sharpness=self.fade_out_sharpness)
                grads = torch.autograd.grad(total.mean(dim=-1).sum(), leaves)
            params = adam.step(params, grads)
        return params

    # ------------------------------------------------------------------- run
    def _run_group(self, noises, uq_generator=None):
        """One group of sims: noises [m, T, 12] -> the outputs' dict;
        uq_generator: the Laplace UQ's draws."""
        m = noises.shape[0]
        true = self.start_state.expand(m, 12)
        xt = true
        sig = self.sig0.expand(m, 12, 12)
        knots = self.knots0.expand((m,) + self.knots0.shape)
        ia = self.initial_accel0.expand(m, 2)
        done = torch.zeros((m,), dtype=torch.bool, device=self.device)
        uq = self.uq_engine
        outs = []
        for t in range(self.steps):
            noise = noises[:, t]
            with torch.no_grad():
                actions = calc_everything(knots, ia, state12_to_18(xt),
                                          self.end_state18, self.dt,
                                          self.g_vec, self.I, self.mass)[6]
                action = actions[:, 0]
                true_next = self._dynamics(true, action) + noise
            target = self._target_pixels(true_next)
            xt_new, sig_new = self._estimate(xt, sig, action, target)
            knots_new, ia_new = self._replan(
                torch.cat([knots[:, 1:], knots[:, -1:]], dim=1),
                actions[:, 1:3, 0], state12_to_18(xt_new))
            with torch.no_grad():
                hit, sdf_val, pos = self._sdf_check_interp(true, true_next,
                                                           t)
                collided_now = hit & ~done

                def keep(new, old):
                    d = done.reshape((m,) + (1,) * (new.dim() - 1))
                    return torch.where(d, old, new)

                true_next = keep(true_next, true)
                xt_new = keep(xt_new, xt)
                sig_new = keep(sig_new, sig)
                knots_new = keep(knots_new, knots)
                ia_new = keep(ia_new, ia)
                loglik = self._log_likelihood(noise)
                if uq is not None:
                    sigma_d, reward, _ = uq._uq_reward(true_next, loglik,
                                                       uq_generator)
                else:
                    sigma_d = reward = torch.zeros((m,), device=self.device)
            outs.append((true_next, xt_new, action, pos, sdf_val,
                         collided_now, loglik, sigma_d, reward))
            true, xt, sig, knots, ia = true_next, xt_new, sig_new, \
                knots_new, ia_new
            done = done | collided_now
        (true_states, est_states, actions, positions, sdf_vals, collided,
         logliks, sigmas, rewards) = (torch.stack(o, dim=1)
                                      for o in zip(*outs))
        return {"true_states": true_states, "est_states": est_states,
                "actions": actions, "positions": positions,
                "sdf_vals": sdf_vals, "collided": collided,
                "ever_collided": done, "log_likelihoods": logliks,
                "sigma_d": sigmas, "reward": rewards,
                "risk": torch.amin(sdf_vals, dim=1)}

    def run(self, noises):
        """noises [n, T, 12] -> {'true_states', 'est_states' [n, T, 12],
        'actions' [n, T, 4], 'positions' [n, T, 3], 'sdf_vals',
        'collided', 'log_likelihoods', 'sigma_d', 'reward' [n, T],
        'ever_collided', 'risk' [n]}, tensors on the engine's device (sigma_d
        and reward 0 without a uq_engine); at most sim_group sims at a
        time."""
        noises = as_f32(noises, self.device)
        n = noises.shape[0]
        g = n if self.sim_group is None else max(1, self.sim_group)
        gen = torch.Generator(device=self.device).manual_seed(0)
        chunks = [self._run_group(noises[i:i + g], gen)
                  for i in range(0, n, g)]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    # ---------------------------------------------------------- stress tests
    def monte_carlo(self, generator, n_sims: int, z=None):
        """A closed-loop MC sweep; numpy outputs. z: optional [n_sims, T,
        12] standard normals (else drawn from `generator`)."""
        noises = self.sample_noises(generator, n_sims, z=z)
        out = {k: v.cpu().numpy() for k, v in self.run(noises).items()}
        return {"noises": noises.cpu().numpy(),
                "collision_rate": float(out["ever_collided"].mean()),
                "ever_collided": out["ever_collided"],
                "true_states": out["true_states"],
                "est_states": out["est_states"], "risk": out["risk"],
                "positions": out["positions"],
                "log_likelihoods": out["log_likelihoods"],
                "sigma_d": out["sigma_d"], "reward": out["reward"]}

    def cem(self, generator, m: int, m_elite: int, kmax: int, csv_path=None,
            z=None):
        """Closed-loop CEM: m rollouts an iteration from the full-covariance
        proposal, the reward-scaled risk (per step sdf - reward 0.01 sdf,
        its least up to the first collision; the plain least SDF without a
        uq_engine), non-finite risks never elite, the exact sequential
        proposal update, and with `csv_path` the reference's 27-column CSV
        appended ([k, sim, step, noise x12, reward_prev, sigma_d, adjusted
        collisionVal, pos x3, log p, log q, cumulative log p, cumulative
        log q, isCollision, everCollided], a sim's rows stopping at its
        first collision). z: optional list of kmax [m, T, 12] standard
        normals."""
        means, covs = self._initial_proposal()
        p_mean, p_cov = means.copy(), covs.copy()
        history = []
        for k in range(kmax):
            noises = self.sample_noises(generator, m, means, covs=covs,
                                        z=None if z is None else z[k])
            out = {kk: v.cpu().numpy() for kk, v in self.run(noises).items()}
            nz = noises.cpu().numpy()
            adj = out["sdf_vals"] - out["reward"] * 0.01 * out["sdf_vals"]
            risks = np.empty(m)
            for i in range(m):
                T_i = self.steps
                if out["collided"][i].any():
                    T_i = int(np.argmax(out["collided"][i])) + 1
                risks[i] = adj[i, :T_i].min()
            risks = _finite_risks(risks)
            if csv_path is not None:
                r_prev = np.concatenate(
                    [np.zeros((m, 1)), out["reward"][:, :-1]], axis=1)
                self._append_cem_csv(
                    csv_path, k, dict(out, noises=nz,
                                            reward_prev=r_prev),
                    adj, means, covs, p_mean, p_cov)
            elite_idx = np.argsort(risks)[:m_elite]
            means, covs = _cem_proposal_update(nz[elite_idx], means, covs,
                                               p_mean, p_cov)
            finite = risks[np.isfinite(risks)]
            history.append({
                "mean_risk": float(finite.mean()) if finite.size
                else float("nan"),
                "elite_risk": float(risks[elite_idx].mean()),
                "collision_rate": float(out["collided"].any(1).mean()),
                "n_diverged": int(m - finite.size)})
        return {"means": means, "covs": covs,
                "vars": np.stack([np.diag(c) for c in covs]),
                "history": history}
