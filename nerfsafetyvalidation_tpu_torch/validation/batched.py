"""The batched rollout engines (nerfsafetyvalidation_tpu/validation/
batched.py): whole populations of Monte Carlo and cross-entropy
disturbance trajectories stepped together.

`BatchedRolloutEngine` is the open-loop core: per step the quadrotor
dynamics under the planner's actions plus a disturbance, the SDF lookup
(a collision below one cell, the state frozen after the first), and the
disturbance's per-step Gaussian log-likelihood with the reference's pdf
clip. `FullBatchedRolloutEngine` adds, per sim and step, the NeRF
observation render at `obs_res`^2, the UQ (the Gaussian approximation, a
fixed-iteration Adam on its two parameters; or the Bayesian Laplace
approximation, `uq_method="laplace"`), the safety-masked reward that
scales the next step's disturbance (Monte Carlo) and the 4-point
interpolated SDF check.

The in-scan Laplace (`_laplace_uq`, the JAX version's :467-574): per sim
and step, `laplace_points` of the observation's points rays_o + rays_d
(stride-subsampled) against its aggregated density, MAP fits of the
sim's own sigma-net vector from a random normal start on
`laplace_perturbations` moved copies of the points (Adam over
exponential_decay(lr, 100, 0.1)), the best kept, then a fixed number of
Levenberg-Marquardt steps with `where` logic on the rank-one g g^T
(Sherman-Morrison, no dense solve), and the posterior's trace and root
mean variance from the diagonal of (g g^T + 1e-2 I)^-1. The JAX version
vmaps it over the sims, which runs its fused MLP kernel with one weight
set per sim; here the whole population's fits are one batch, [m, points]
and [m, n_theta], through the nets' `sigma_of_encoding`, on a fused grid
net (`--ff`) the grouped K4 (one launch a forward).

The JAX package maps `scan(step)` over the population with `vmap`. Here the
steps are a Python loop over tensors of the whole population ([m, 12]
states): the dynamics, likelihood, UQ, reward and SDF check are single
tensor ops over it. The observations render `obs_group` sims a call on the
`uniform` path (their rays concatenated into one `run`; rays are
independent, so this is exact) and one frame a sim on the frame paths
(`fast`, `guided`, `scout`), whose sort, tiles, prepass and moments are
per frame. The renders run through the nets' kernels (K1, K3, K4) on the
card; the renderers' `plain_field` switch is never set here.

Random draws: threefry cannot be reproduced in torch. `monte_carlo` and
`cem` draw standard normals from a `torch.Generator` on the engine's
device, or take them from the caller (`z`), as the tests hand in the JAX
package's own. The Laplace fits' draws (per step: theta's init [m, n] and
the perturbations [m, P, points, 3]) come from a generator seeded 0 at
each run (the JAX version keys each run's from PRNGKey(0)), or from the
caller (`laplace_draws`).
Every tensor lives on the engine's `device` ("cuda" unless the caller
passes another). The proposal updates and the CSVs are numpy on the host,
as in the JAX package.

Not ported yet: sharding over a device mesh (`mesh`) raises."""

import csv
import math
import os
from functools import partial

import numpy as np
import torch

from ..data.rays import get_rays
from ..models import renderer as R
from ..nav.agent import drone_dynamics
from ..nav.math_utils import (as_f32 as _f32, nerf_matrix_to_ngp,
                               rot_matrix_to_vec, rot_x, vec_to_rot_matrix)
from ..uq.bayesian_laplace import map_fit, negative_log_posterior, \
    nlp_and_grad
from ..utils.adam import Adam
from .stresstests.cross_entropy import _weighted_mean_cov

_LOG_2PI = float(np.log(2.0 * np.pi))


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "sharding the population over a device mesh "
            "(parallel/mesh.py) waits for slice G of the port")


def start_state_from_pose(c2w):
    """A state at rest [12] (float32 numpy) whose observation camera is the
    raw-frame camera-to-world c2w [4, 4]: `_pose_from_state` inverted. Its
    position is c2w's translation and its rotation R = rot_x(pi) @ c2w's
    rotation (rot_x(pi) is its own inverse), as a rotation vector."""
    c2w = torch.as_tensor(np.asarray(c2w, dtype=np.float32))
    rotvec = rot_matrix_to_vec(rot_x(math.pi) @ c2w[:3, :3])
    zeros = torch.zeros(3)
    return torch.cat([c2w[:3, 3], zeros, rotvec, zeros]).numpy()


def _cem_proposal_update(elite, q_mean, q_cov, p_mean, p_cov):
    """One CEM proposal refresh over all steps: importance weights p/q from
    full mvn log-densities, log-sum-exp normalized, clamped at 1e-8; the
    torch.cov(aweights) weighted covariance, of which only the diagonal is
    kept, clamped to [0, 0.1] and floored at 1e-12.

    elite: [E, T, 12]; q_mean/p_mean: [T, 12]; q_cov/p_cov: [T, 12, 12]
    (numpy). Returns (new_means [T, 12], new_covs [T, 12, 12]) in the
    dtypes of q_mean and q_cov."""
    T = q_mean.shape[0]
    new_means = np.empty_like(q_mean)
    new_covs = np.empty_like(q_cov)
    for t in range(T):
        lp = BatchedRolloutEngine._mvn_logpdf(elite[:, t], p_mean[t], p_cov[t])
        lq = BatchedRolloutEngine._mvn_logpdf(elite[:, t], q_mean[t], q_cov[t])
        lw = lp - lq
        lw = lw - (np.max(lw) + np.log(np.exp(lw - np.max(lw)).sum()))
        w = np.exp(lw)
        if np.any(w <= 0):
            w = np.clip(w, 1e-8, None)
        mean_t, cov_t = _weighted_mean_cov(elite[:, t], w)
        diag = np.diag(cov_t).copy()
        if (diag > 0.1).any() or (diag < 0).any():
            diag = np.clip(diag, 0.0, 0.1)
        diag = np.maximum(diag, 1e-12)
        new_means[t] = mean_t
        new_covs[t] = np.diag(diag)
    return new_means, new_covs


class BatchedRolloutEngine:
    def __init__(self, actions, dt, g, mass, I, sdf, sdf_start, granularity,
                 noise_mean, noise_std, start_state, mesh=None,
                 device="cuda"):
        """actions: [T, 4] planner actions (open loop); sdf: [X, Y, Z]
        signed distances in metres; sdf_start: [3] world position of the
        grid's origin; granularity: cells a metre; noise_mean/std: [12];
        start_state: [12]. Arrays may be numpy or tensors; they are copied
        to `device` as float32."""
        _no_mesh(mesh)
        self.device = dev = torch.device(device)
        self.actions = _f32(actions, dev)
        self.steps = self.actions.shape[0]
        self.dt = float(dt)
        self.g = float(g)
        self.mass = float(mass)
        self.I = _f32(I, dev)
        self.invI = torch.linalg.inv(self.I)
        self.sdf = _f32(sdf, dev)
        self.sdf_start = _f32(sdf_start, dev)
        self.granularity = float(granularity)
        self.noise_mean = _f32(noise_mean, dev)
        self.noise_std = _f32(noise_std, dev)
        self.start_state = _f32(start_state, dev)
        self._sdf_shape = torch.tensor(self.sdf.shape, dtype=torch.int32,
                                       device=dev)
        self._log_clip = (torch.log(torch.tensor(1e-8, device=dev)),
                          torch.log(torch.tensor(1e8, device=dev)))

    # ------------------------------------------------------------------ core
    def _dynamics(self, states, action):
        return drone_dynamics(states, action, self.dt, self.g, self.mass,
                              self.I, self.invI)

    def _sdf_lookup(self, pos):
        """SDF value at world positions [..., 3] -> [...]; a position outside
        the grid reads 9999 (the reference's IndexError: no collision)."""
        idx = torch.floor((pos - self.sdf_start) * self.granularity) \
            .to(torch.int32)
        inb = ((idx >= 0) & (idx < self._sdf_shape)).all(dim=-1)
        c = torch.minimum(torch.clamp(idx, min=0), self._sdf_shape - 1).long()
        val = self.sdf[c[..., 0], c[..., 1], c[..., 2]]
        return torch.where(inb, val, 9999.0)

    def _log_likelihood(self, noise):
        """Per-step diagonal-Gaussian log-likelihood of noise [..., 12] ->
        [...], each dimension's log-density clipped to [log 1e-8, log
        1e8] (the reference's pdf clip)."""
        var = self.noise_std ** 2
        logpdf = -0.5 * ((noise - self.noise_mean) ** 2 / var
                         + torch.log(var) + _LOG_2PI)
        lo, hi = self._log_clip
        return torch.sum(torch.minimum(torch.maximum(logpdf, lo), hi),
                         dim=-1)

    def _sdf_check_interp(self, prev_state, state, step_idx: int):
        """4-point interpolated SDF check, the sequential simulator's
        np.interp over its history: with N = step + 2 states, the last 4 of
        the 4N-point refinement lie at fractions j (N - 1) / (4N - 1) -
        (N - 2) of the last segment. prev_state/state [m, 12] -> (hit [m],
        the SDF value at the first colliding point (else the last) [m],
        that point [m, 3])."""
        n = step_idx + 2.0          # small integers: exact in float32
        js = torch.arange(4, dtype=torch.float32, device=self.device) \
            + (4.0 * n - 4.0)
        frac = js * (n - 1.0) / (4.0 * n - 1.0) - (n - 2.0)
        pts = prev_state[:, None, :3] + frac[None, :, None] \
            * (state[:, :3] - prev_state[:, :3])[:, None]         # [m, 4, 3]
        vals = self._sdf_lookup(pts)
        hit = vals < 1.0 / self.granularity
        any_hit = hit.any(dim=1)
        idx = torch.where(any_hit, hit.to(torch.int32).argmax(dim=1), 3)
        rows = torch.arange(pts.shape[0], device=self.device)
        return any_hit, vals[rows, idx], pts[rows, idx]

    def _append_cem_csv(self, csv_path, k, out, adj, means, covs, p_mean,
                        p_cov):
        """One CEM iteration's rows (see `cem`); the per-step log-densities
        under p and q are full mvn, the cumulative ones running sums."""
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        m = out["noises"].shape[0]
        lp_steps = np.stack([self._mvn_logpdf(out["noises"][:, t], p_mean[t],
                                              p_cov[t])
                             for t in range(self.steps)], axis=1)
        lq_steps = np.stack([self._mvn_logpdf(out["noises"][:, t], means[t],
                                              covs[t])
                             for t in range(self.steps)], axis=1)
        lp_cum = np.cumsum(lp_steps, axis=1)
        lq_cum = np.cumsum(lq_steps, axis=1)
        with open(csv_path, "a", newline="") as f:
            w = csv.writer(f)
            for i in range(m):
                ever = bool(out["collided"][i].any())
                for t in range(self.steps):
                    row = [k, i, t]
                    row.extend(out["noises"][i, t].tolist())
                    row.append(float(out["reward_prev"][i, t]))
                    row.append(float(out["sigma_d"][i, t]))
                    row.append(float(adj[i, t]))
                    row.extend(out["positions"][i, t].tolist())
                    row.append(float(lp_steps[i, t]))
                    row.append(float(lq_steps[i, t]))
                    row.append(float(lp_cum[i, t]))
                    row.append(float(lq_cum[i, t]))
                    row.append(bool(out["collided"][i, t]))
                    row.append(ever)
                    w.writerow(row)
                    if out["collided"][i, t]:
                        break

    @torch.no_grad()
    def run(self, noises):
        """noises: [n, T, 12] -> {'positions' [n, T, 3], 'sdf_vals' [n, T],
        'collided' [n, T] (the first hit only), 'ever_collided' [n],
        'log_likelihoods' [n, T], 'risk' [n] (the least SDF value)}."""
        noises = _f32(noises, self.device)
        n = noises.shape[0]
        thresh = 1.0 / self.granularity
        state = self.start_state.expand(n, 12)
        done = torch.zeros((n,), dtype=torch.bool, device=self.device)
        outs = []
        for t in range(self.steps):
            nxt = self._dynamics(state, self.actions[t]) + noises[:, t]
            state = torch.where(done[:, None], state, nxt)
            sdf_val = self._sdf_lookup(state[:, :3])
            collided_now = (sdf_val < thresh) & ~done
            outs.append((state[:, :3], sdf_val, collided_now,
                         self._log_likelihood(noises[:, t])))
            done = done | collided_now
        positions, sdf_vals, collided, logliks = (torch.stack(o, dim=1)
                                                  for o in zip(*outs))
        return {"positions": positions, "sdf_vals": sdf_vals,
                "collided": collided, "ever_collided": done,
                "log_likelihoods": logliks,
                "risk": torch.amin(sdf_vals, dim=1)}

    # ------------------------------------------------------------------ APIs
    def _normals(self, generator, n_sims, z=None):
        """[n_sims, T, 12] standard normals: `z` as given, or drawn from
        `generator` (a torch.Generator on the engine's device)."""
        if z is not None:
            return _f32(z, self.device)
        return torch.randn((n_sims, self.steps, 12), generator=generator,
                           device=self.device)

    def sample_noises(self, generator, n_sims: int, means=None,
                      covs_diag=None, covs=None, z=None):
        """[n_sims, T, 12] disturbances: per-step means [T, 12] (default the
        MC mean) plus either diagonal variances covs_diag [T, 12] or full
        covariances covs [T, 12, 12] (through their Cholesky factors) times
        standard normals (see `_normals`); the default is the MC std."""
        dev = self.device
        if means is None:
            means = self.noise_mean.expand(self.steps, 12)
        means = _f32(means, dev)
        z = self._normals(generator, n_sims, z)
        if covs is not None:
            L = torch.linalg.cholesky(_f32(covs, dev))
            return means[None] + torch.einsum("tij,ntj->nti", L, z)
        if covs_diag is None:
            stds = self.noise_std.expand(self.steps, 12)
        else:
            stds = torch.sqrt(_f32(covs_diag, dev))
        return means[None] + stds[None] * z

    def monte_carlo(self, generator, n_sims: int, z=None):
        """One batched MC sweep; returns numpy arrays and the collision
        rate."""
        noises = self.sample_noises(generator, n_sims, z=z)
        out = {k: v.cpu().numpy() for k, v in self.run(noises).items()}
        return {
            "noises": noises.cpu().numpy(),
            "collision_rate": float(out["ever_collided"].mean()),
            "ever_collided": out["ever_collided"],
            "first_collision_step": np.argmax(out["collided"], axis=1),
            "risk": out["risk"],
            "positions": out["positions"],
            "log_likelihoods": out["log_likelihoods"],
        }

    def _initial_proposal(self):
        means = np.broadcast_to(self.noise_mean.cpu().numpy(),
                                (self.steps, 12)).copy()
        covs = np.broadcast_to(np.diag(self.noise_std.cpu().numpy() ** 2),
                               (self.steps, 12, 12)).copy()
        return means, covs

    def cem(self, generator, m: int, m_elite: int, kmax: int, z=None):
        """Batched CEM: per iteration m rollouts from the full-covariance
        proposal, the m_elite of least risk, and `_cem_proposal_update`.
        z: optional list of kmax [m, T, 12] standard normals."""
        means, covs = self._initial_proposal()
        p_mean, p_cov = means.copy(), covs.copy()
        history = []
        for k in range(kmax):
            noises = self.sample_noises(generator, m, means, covs=covs,
                                        z=None if z is None else z[k])
            out = self.run(noises)
            risks = out["risk"].cpu().numpy()
            elite_idx = np.argsort(risks)[:m_elite]
            elite = noises.cpu().numpy()[elite_idx]
            means, covs = _cem_proposal_update(elite, means, covs,
                                               p_mean, p_cov)
            history.append({"mean_risk": float(risks.mean()),
                            "elite_risk": float(risks[elite_idx].mean()),
                            "collision_rate": float(
                                out["ever_collided"].float().mean())})
        return {"means": means, "covs": covs,
                "vars": np.stack([np.diag(c) for c in covs]),
                "history": history}

    @staticmethod
    def _diag_logpdf(x, mean, var):
        return (-0.5 * ((x - mean) ** 2 / var + np.log(var)
                        + _LOG_2PI)).sum(-1)

    @staticmethod
    def _mvn_logpdf(x, mean, cov):
        """Full multivariate-normal log-density, float64, via Cholesky."""
        L = np.linalg.cholesky(np.asarray(cov, dtype=np.float64))
        diff = np.asarray(x, dtype=np.float64) - mean
        sol = np.linalg.solve(L, diff.T)                    # [D, M]
        maha = (sol ** 2).sum(0)
        logdet = 2.0 * np.log(np.diag(L)).sum()
        d = mean.shape[-1]
        return -0.5 * (maha + logdet + d * _LOG_2PI)


def _uq_grad(S_c2d2, S_cd, r_mean, mu, sig):
    """The gradient of log(s2) + (r_mean - S_cd mu)^2 / s2, s2 =
    max(S_c2d2 sig^2, 1e-30), in (mu, sig), in the order of operations of
    JAX's reverse-mode derivative of it (integer powers as products, the
    quotient's cotangent -x / y^2, max's cotangent split where the two
    are equal)."""
    tiny = 1e-30                    # compared in float32, as JAX does
    b = S_c2d2 * (sig * sig)
    s2 = torch.clamp(b, min=tiny)
    r = r_mean - S_cd * mu
    inv = 1.0 / s2
    ct_s2 = inv + (-(r * r)) * (1.0 / (s2 * s2))
    ct_b = ct_s2 * torch.where(b > tiny, 1.0, torch.where(b == tiny, 0.5,
                                                          0.0))
    return S_cd * -(inv * (2.0 * r)), (S_c2d2 * ct_b) * (2.0 * sig)


class FullBatchedRolloutEngine(BatchedRolloutEngine):
    def __init__(self, actions, dt, g, mass, I, sdf, sdf_start, granularity,
                 noise_mean, noise_std, start_state, net=None, obs_res=100,
                 render_steps=64, base_intrinsics=None, base_res=800,
                 uq_iters=100, uq_lr=1e-2, penalty_strength=36.0, mesh=None,
                 renderer_state=None, grid_max_samples=16, obs_group=1,
                 uq_method="gaussian", obs_render="uniform",
                 obs_prepass_factor=8, obs_dt_gamma=1.0 / 64,
                 laplace_fit_steps=100, laplace_points=256,
                 laplace_perturbations=3, laplace_scale=0.3,
                 laplace_lm_iters=20, laplace_prior_std=1.0,
                 laplace_lr=1e-2, device="cuda"):
        """The core engine's arguments, and: net, the port's field (it
        holds its weights: the JAX version's `params` has no counterpart);
        obs_res, the observation's side; base_intrinsics (fx, fy, cx, cy)
        at base_res, scaled to obs_res (default 1111 px focal at 800);
        render_steps, the `uniform` path's samples a ray; renderer_state,
        the occupancy (the frame paths need it; with it `uniform` marches
        through `run_grid`, grid_max_samples a ray); obs_group, the sims
        whose `uniform` observations render in one call; uq_iters / uq_lr,
        the UQ's Adam; penalty_strength, the reward's.

        obs_render: "uniform" (`run`, or `run_grid` with a renderer_state:
        per-sample rgbs and sigmas), "fast" (`render_frame_fast` with the
        UQ moments), "guided" (`render_frame_guided`, march prepass),
        "scout" (`render_frame_guided`, scout prepass).
        uq_method: "gaussian", or "laplace" (the laplace_* knobs, the JAX
        version's defaults, on the net's sigma-net flatpack)."""
        _no_mesh(mesh)
        if net is None:
            raise ValueError("FullBatchedRolloutEngine renders through a "
                             "net; the core engine is BatchedRolloutEngine")
        if uq_method not in ("gaussian", "laplace"):
            raise ValueError(f"unknown in-scan uq_method {uq_method!r}")
        if obs_render not in ("uniform", "fast", "guided", "scout"):
            raise ValueError(f"unknown obs_render {obs_render!r}")
        if obs_render != "uniform" and renderer_state is None:
            raise ValueError(f"obs_render={obs_render!r} needs the marched "
                             "renderer_state (occupancy grid)")
        super().__init__(actions, dt, g, mass, I, sdf, sdf_start, granularity,
                         noise_mean, noise_std, start_state, device=device)
        self.net = net
        self.obs_res = int(obs_res)
        self.render_steps = int(render_steps)
        self.renderer_state = renderer_state
        self.grid_max_samples = int(grid_max_samples)
        self.obs_group = max(1, int(obs_group))
        if base_intrinsics is None:
            base_intrinsics = (1111.0, 1111.0, base_res / 2, base_res / 2)
        s = self.obs_res / float(base_res)
        self.intrinsics = tuple(v * s for v in base_intrinsics)
        self.uq_iters = int(uq_iters)
        self.uq_lr = float(uq_lr)
        self.penalty_strength = float(penalty_strength)
        self.uq_method = uq_method
        self.obs_render = obs_render
        self.obs_prepass_factor = int(obs_prepass_factor)
        self.obs_dt_gamma = float(obs_dt_gamma)
        self.laplace_fit_steps = int(laplace_fit_steps)
        self.laplace_points = int(laplace_points)
        self.laplace_perturbations = int(laplace_perturbations)
        self.laplace_scale = float(laplace_scale)
        self.laplace_lm_iters = int(laplace_lm_iters)
        self.laplace_prior_std = float(laplace_prior_std)
        self.laplace_lr = float(laplace_lr)

    # ------------------------------------------------------------- obs render
    def _pose_from_state(self, states):
        """States [m, 12] -> NGP camera poses [m, 4, 4] along the sequential
        loop's observation chain: the agent's camera applies rot_x(pi/2)
        and the render applies it again before the NGP remap, so the camera
        rotation is rot_x(pi) @ R."""
        rot = rot_x(math.pi, self.device) @ vec_to_rot_matrix(states[:, 6:9])
        p, t = nerf_matrix_to_ngp(rot, states[:, :3])
        pose = torch.eye(4, device=self.device).repeat(states.shape[0], 1, 1)
        pose[:, :3, :3] = p
        pose[:, :3, 3] = t
        return pose

    def _obs_rays(self, poses):
        """(rays_o, rays_d) [len(poses) * obs_res^2, 3] of the poses'
        observations."""
        rays = get_rays(poses, self.intrinsics, self.obs_res, self.obs_res,
                        device=self.device)
        return rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3)

    def _obs_call(self):
        """The observation render of this engine's obs_render, as a function
        of (rays_o, rays_d) (its other keywords, e.g. `plain_field`,
        passed through): the JAX version's settings (batched.py:353-389).
        On the frame paths the rays are one frame's."""
        net, state = self.net, self.renderer_state
        K, gamma = self.grid_max_samples, self.obs_dt_gamma
        n = self.obs_res ** 2
        tile = min(131072, -(-n // 1024) * 1024)
        if self.obs_render == "fast":
            return partial(R.render_frame_fast, net, state, tile=tile,
                           max_samples=K, max_steps=512, dt_gamma=gamma,
                           samples_per_hit=2, march_tile=min(32768, tile),
                           return_moments=True)
        if self.obs_render in ("guided", "scout"):
            # the JAX version's natural tile order caps its tiles at 8,192
            return partial(R.render_frame_guided, net, state,
                           H=self.obs_res, W=self.obs_res,
                           prepass_factor=self.obs_prepass_factor,
                           max_samples=K, tile=min(tile, 8192), max_steps=512,
                           dt_gamma=gamma, return_moments=True,
                           prepass_mode=("scout" if self.obs_render == "scout"
                                         else "march"))
        if state is not None:
            return partial(R.run_grid, net, state, max_samples=K,
                           max_steps=512, bg_color=1.0, samples_per_hit=2)
        return partial(R.run, net, num_steps=self.render_steps,
                       upsample_steps=0, bg_color=1.0)

    def _obs_stats(self, out, g: int = 1):
        """The Gaussian UQ's inputs [g, 5] (S_c2d2, S_cd, mean image, mean
        and std of sigma) of the g observations one `_obs_call` rendered:
        from the frame's in-pass moments over n rays x grid_max_samples
        slots, or from the per-sample rgbs and sigmas."""
        img = out["image"].reshape(g, -1)
        if "uq_moments" in out:
            return torch.stack(_moment_stats(
                out["uq_moments"][None], img,
                float(out["image"].shape[0] // g * self.grid_max_samples)),
                dim=-1)
        rgbs = out["rgbs"].reshape(g, -1, 3)
        return torch.stack(_direct_stats(
            rgbs, out["sigmas"].reshape(g, -1, 1), img), dim=-1)

    def _render_stats(self, states):
        """Every sim's observation rendered, states [m, 12] -> [m, 5]."""
        poses = self._pose_from_state(states)
        call = self._obs_call()
        G = self.obs_group if self.obs_render == "uniform" else 1
        stats = []
        for g0 in range(0, poses.shape[0], G):
            group = poses[g0:g0 + G]
            stats.append(self._obs_stats(call(*self._obs_rays(group)),
                                         group.shape[0]))
        return torch.cat(stats)

    def _render_laplace(self, states):
        """The Laplace fits' data of every sim's observation, states [m, 12]
        -> (X [m, P, 3], y [m, P]): P = laplace_points of the points rays_o
        + rays_d, every (n / P)-th ray, and their aggregated densities."""
        poses = self._pose_from_state(states)
        call = self._obs_call()
        G = self.obs_group if self.obs_render == "uniform" else 1
        n = self.obs_res ** 2
        P = self.laplace_points
        idx = (torch.arange(P, device=self.device) * n) // max(P, 1)
        Xs, ys = [], []
        for g0 in range(0, poses.shape[0], G):
            o, d = self._obs_rays(poses[g0:g0 + G])
            agg = call(o, d)["aggregated_density"].reshape(-1, n)
            Xs.append((o + d).reshape(-1, n, 3)[:, idx])
            ys.append(agg[:, idx])
        return torch.cat(Xs), torch.cat(ys)

    # ------------------------------------------------------------------- UQ
    def _laplace_draws(self, generator, m):
        """(theta's inits [m, n], the perturbations' standard normals [m,
        laplace_perturbations, laplace_points, 3]) of one step."""
        n = self.net.get_sigma_net_flat().shape[0]
        theta0 = torch.randn((m, n), generator=generator, device=self.device)
        perts = torch.randn((m, self.laplace_perturbations,
                             self.laplace_points, 3), generator=generator,
                            device=self.device)
        return theta0, perts

    def _laplace_nlp(self, theta, h, y):
        """Each sim's -log posterior [m] at theta [m, n] on its points,
        encoded as h [m, P, D], against y [m, P] (prior N(0, std^2))."""
        return negative_log_posterior(self.net, theta, h, y, 0.0,
                                      self.laplace_prior_std)

    @torch.no_grad()
    def _laplace_map(self, X, y, theta0, perts):
        """The MAP fits of every sim: X [m, P, 3], y [m, P], theta0 [m, n],
        perts [m, laplace_perturbations, P, 3] standard normals -> the best
        theta [m, n] over the moved copies of X (per copy the sequential
        fit's `map_fit`, all sims at once; the first copy wins ties)."""
        losses, thetas = [], []
        for p in range(self.laplace_perturbations):
            h = self.net.encode_pos(X + perts[:, p] * self.laplace_scale)
            loss, theta = map_fit(self.net, theta0, h, y, 0.0,
                                  self.laplace_prior_std, self.laplace_lr,
                                  self.laplace_fit_steps)
            losses.append(loss)
            thetas.append(theta)
        best = torch.argmin(torch.stack(losses), dim=0)
        return torch.stack(thetas)[best, torch.arange(X.shape[0],
                                                      device=X.device)]

    @torch.no_grad()
    def _laplace_lm(self, x, X, y):
        """laplace_lm_iters Levenberg-Marquardt steps from x [m, n] with
        `where` logic: dx solves (g g^T + lmbda I) dx = -g, that is dx =
        -g / (lmbda + |g|^2) (Sherman-Morrison on the rank one); x moves
        by dx in any case; lmbda falls tenfold where f(x + dx) < f(x0),
        else rises; a sim whose dx is below 1e-12 everywhere stops.
        Returns each sim's last x [m, n], g [m, n] (g at the step where it
        stopped), lmbda [m] and whether it stopped [m]."""
        h = self.net.encode_pos(X)
        prior_std = self.laplace_prior_std
        f_x0 = self._laplace_nlp(x, h, y)
        lmbda = torch.full_like(f_x0, 0.01)
        g_last = torch.zeros_like(x)
        done = torch.zeros_like(f_x0, dtype=torch.bool)
        for _ in range(self.laplace_lm_iters):
            g = nlp_and_grad(self.net, x, h, y, 0.0, prior_std)[1]
            g_last = torch.where(done[:, None], g_last, g)
            dx = -g / (lmbda + torch.sum(g ** 2, dim=-1))[:, None]
            converged = torch.all(torch.abs(dx) < 1e-12, dim=-1)
            x_new = x + dx
            improved = self._laplace_nlp(x_new, h, y) < f_x0
            lmbda_new = torch.where(improved, lmbda / 10.0, lmbda * 10.0)
            keep = done | converged
            x = torch.where(keep[:, None], x, x_new)
            lmbda = torch.where(keep, lmbda, lmbda_new)
            done = keep
        return x, g_last, lmbda, done

    def _laplace_uq(self, X, y, theta0, perts):
        """The in-scan Laplace UQ of every sim (the JAX version's
        `_laplace_uq`, vmapped over the sims there): the MAP fits, the LM
        steps, and of cov = (g g^T + eps I)^-1, eps = 1e-2, the diagonal
        1/eps - g_i^2 / (eps (eps + |g|^2)) (all >= 0) -> (trace [m] =
        sum(diag) / n, rmv [m] = sqrt(mean(diag)) / n)."""
        g = self._laplace_lm(self._laplace_map(X, y, theta0, perts), X,
                             y)[1]
        eps = 1e-2
        s = torch.sum(g ** 2, dim=-1)
        diag = 1.0 / eps - g ** 2 / (eps * (eps + s))[:, None]
        n = g.shape[-1]
        return (torch.sum(diag, dim=-1) / n,
                torch.sqrt(torch.mean(diag, dim=-1)) / n)

    def _uq_reward(self, states, loglik, generator=None, draws=None):
        """The UQ of every sim's observation at states [m, 12] and the
        reward: (sigma_d [m], reward [m], None) with the Gaussian UQ;
        (rmv [m], reward [m], trace [m]) with the Laplace one, its draws
        `draws` (theta0, perts) or from `generator`."""
        if self.uq_method == "laplace":
            X, y = self._render_laplace(states)
            if draws is None:
                draws = self._laplace_draws(generator, states.shape[0])
            trace, rmv = self._laplace_uq(X, y, *(_f32(d, self.device)
                                                  for d in draws))
            return rmv, self._reward_laplace(loglik, rmv, trace), trace
        _, sigma_d = self._gaussian_uq_moments(
            *self._render_stats(states).unbind(dim=-1))
        return sigma_d, self._reward(loglik, sigma_d), None

    def _gaussian_uq(self, rgbs, sigmas, image):
        """The Gaussian-approximation UQ of one observation (or of a batch,
        leading dimensions): rgbs [..., n, K, 3], sigmas [..., n, K], image
        [..., n, 3] -> (mu_d, sigma_d) [...]."""
        lead = image.shape[:-2]
        return self._gaussian_uq_moments(*_direct_stats(
            rgbs.reshape(lead + (-1, 3)), sigmas.reshape(lead + (-1, 1)),
            image.reshape(lead + (-1,))))

    def _gaussian_uq_from_moments(self, moments, image, n_samples):
        """The same UQ from a frame's moments [..., 4] ([S_c2d2, S_cd, S_d,
        S_d2] over n_samples slots) and its image [..., n, 3]."""
        lead = image.shape[:-2]
        return self._gaussian_uq_moments(*_moment_stats(
            moments, image.reshape(lead + (-1,)), float(n_samples)))

    def _gaussian_uq_moments(self, S_c2d2, S_cd, r_mean, d_mean, d_std):
        """Minimizes log(s2) + (r_mean - S_cd mu)^2 / s2, s2 = S_c2d2 sig^2,
        from (d_mean, d_std) by uq_iters steps of Adam (lr uq_lr, betas
        0.9 / 0.999, eps 1e-8), elementwise over the inputs' shape. Where
        S_c2d2 < 1e-18 (a collapsed density) or the iterate is not finite,
        the start is returned. Returns (mu_d, |sigma_d|): the objective is
        symmetric in sigma."""
        degenerate = S_c2d2 < 1e-18
        mu, sig = d_mean, d_std
        adam = Adam([mu, sig], self.uq_lr)
        for _ in range(self.uq_iters):
            mu, sig = adam.step([mu, sig],
                                _uq_grad(S_c2d2, S_cd, r_mean, mu, sig))
        keep = degenerate | ~(torch.isfinite(mu) & torch.isfinite(sig))
        return (torch.where(keep, d_mean, mu),
                torch.abs(torch.where(keep, d_std, sig)))

    def _reward(self, likelihood, sigma_d_opt):
        """Safety-masked reward (the Gaussian branch)."""
        ps = self.penalty_strength
        return torch.clamp(likelihood - ps * sigma_d_opt, -ps * 2, ps)

    def _reward_laplace(self, likelihood, rmv, trace):
        """The Laplace branch's reward (NerfSimulator.py:170-181): the
        penalty is rmv * trace * laplace_perturbations."""
        ps = self.penalty_strength
        pen = ps * rmv * trace * self.laplace_perturbations
        return torch.clamp(likelihood - pen, -ps * 2, ps)

    # ---------------------------------------------------------------- rollout
    def _run_body(self, z, q_mean, q_chol, adapt_gain: float,
                  laplace_draws=None):
        """z/q_mean: [m, T, 12]; q_chol: [T, 12, 12]. Per step: the
        disturbance q_mean + scale (z @ L^T), scale = 1 + adapt_gain 0.01
        reward_prev (the reference MC's reward-adapted std; 0 for CEM), the
        dynamics (frozen once collided), the observations and their UQ, the
        likelihood, the reward, the SDF check. The Laplace UQ's draws:
        laplace_draws[t] = (theta0, perts), or a generator seeded 0."""
        m = z.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(0)
        traces = []
        states = self.start_state.expand(m, 12)
        done = torch.zeros((m,), dtype=torch.bool, device=self.device)
        reward_prev = torch.zeros((m,), device=self.device)
        outs = []
        for t in range(self.steps):
            scale = 1.0 + adapt_gain * 0.01 * reward_prev
            noise = q_mean[:, t] + scale[:, None] * (z[:, t] @ q_chol[t].T)
            nxt = self._dynamics(states, self.actions[t]) + noise
            nxt = torch.where(done[:, None], states, nxt)
            loglik = self._log_likelihood(noise)
            sigma_d, reward, trace = self._uq_reward(
                nxt, loglik, gen,
                None if laplace_draws is None else laplace_draws[t])
            traces.append(trace)
            hit, sdf_val, pos = self._sdf_check_interp(states, nxt, t)
            collided_now = hit & ~done
            outs.append((noise, pos, sdf_val, collided_now, loglik,
                         reward_prev, sigma_d, reward))
            states, done, reward_prev = nxt, done | collided_now, reward
        (noises, positions, sdf_vals, collided, logliks, rewards_prev,
         sigmas, rewards) = (torch.stack(o, dim=1) for o in zip(*outs))
        extra = {} if traces[0] is None else {
            "trace": torch.stack(traces, dim=1)}   # [m, T] (Laplace)
        return {**extra,
            "noises": noises,                  # [m, T, 12] (std-adapted)
            "positions": positions,            # [m, T, 3]
            "sdf_vals": sdf_vals,              # [m, T]
            "collided": collided,              # [m, T]
            "ever_collided": done,             # [m]
            "log_likelihoods": logliks,        # [m, T]
            "reward_prev": rewards_prev,       # [m, T] (CSV semantics)
            "sigma_d": sigmas,                 # [m, T] (rmv: Laplace)
            "reward": rewards,                 # [m, T]
            "risk": torch.amin(sdf_vals, dim=1),
        }

    @torch.no_grad()
    def run(self, z, q_mean=None, q_std=None, q_chol=None,
            adapt_std: bool = True, laplace_draws=None):
        """z: [n, T, 12] standard normals. The proposal: means q_mean
        [T, 12] (default the MC mean) and either a diagonal q_std [T, 12]
        (default the MC std) or full-covariance Cholesky factors q_chol
        [T, 12, 12]. adapt_std scales each step's disturbance by the
        previous reward (the reference MC); CEM samples its proposal
        verbatim (False). laplace_draws: the Laplace UQ's draws
        (see `_run_body`). Returns the dict of `_run_body`, tensors on the
        engine's device (with the Laplace UQ, 'sigma_d' is the rmv and
        'trace' the trace)."""
        dev = self.device

        def steps12(x, default):
            x = default if x is None else _f32(x, dev)
            return x.expand(self.steps, 12)

        z = _f32(z, dev)
        q_mean = steps12(q_mean, self.noise_mean)
        if q_chol is None:
            q_chol = torch.diag_embed(steps12(q_std, self.noise_std))
        q_chol = _f32(q_chol, dev)
        qm = q_mean[None].expand((z.shape[0],) + q_mean.shape)
        return self._run_body(z, qm, q_chol, 1.0 if adapt_std else 0.0,
                              laplace_draws)

    # ---------------------------------------------------------- stress tests
    def monte_carlo(self, generator, n_sims: int, z=None,
                    laplace_draws=None):
        """Full-fidelity batched MC sweep; numpy outputs (the CSV is
        `write_mc_csv`'s). z: optional [n_sims, T, 12] standard normals;
        laplace_draws: see `_run_body`."""
        out = self.run(self._normals(generator, n_sims, z),
                       laplace_draws=laplace_draws)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def write_mc_csv(self, out, path):
        """The reference MC CSV: [sim, step, noise x12, collisionVal, pos x3,
        curLogLik, cumLogLik, reward_prev, sigma_d, isCollision]; a sim's
        rows stop at its first collision, as the sequential loop breaks."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n, T = out["collided"].shape
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for i in range(n):
                cum = 0.0
                for t in range(T):
                    cum += float(out["log_likelihoods"][i, t])
                    row = [i, t]
                    row.extend(np.asarray(out["noises"][i, t]).tolist())
                    row.append(float(out["sdf_vals"][i, t]))
                    row.extend(np.asarray(out["positions"][i, t]).tolist())
                    row.append(float(out["log_likelihoods"][i, t]))
                    row.append(cum)
                    row.append(float(out["reward_prev"][i, t]))
                    row.append(float(out["sigma_d"][i, t]))
                    row.append(bool(out["collided"][i, t]))
                    w.writerow(row)
                    if out["collided"][i, t]:
                        break

    def cem(self, generator, m: int, m_elite: int, kmax: int, csv_path=None,
            z=None):
        """Full-fidelity batched CEM: the proposal sampled verbatim through
        its Cholesky factors, the reward-scaled risk (per step sdf - reward
        0.01 sdf, its least up to the first collision), the exact
        sequential proposal update, and with `csv_path` the reference's
        27-column CSV appended: [k, sim, step, noise x12, reward_prev,
        sigma_d, adjusted collisionVal, pos x3, log p, log q, cumulative
        log p, cumulative log q, isCollision, everCollided], a sim's rows
        stopping at its first collision. z: optional list of kmax [m, T,
        12] standard normals."""
        means, covs = self._initial_proposal()
        p_mean, p_cov = means.copy(), covs.copy()
        history = []
        for k in range(kmax):
            zk = self._normals(generator, m, None if z is None else z[k])
            out = self.run(zk, means, q_chol=np.linalg.cholesky(covs),
                           adapt_std=False)
            out = {kk: v.cpu().numpy() for kk, v in out.items()}

            adj = out["sdf_vals"] - out["reward"] * 0.01 * out["sdf_vals"]
            risks = np.empty(m)
            for i in range(m):
                T_i = self.steps
                if out["collided"][i].any():
                    T_i = int(np.argmax(out["collided"][i])) + 1
                risks[i] = adj[i, :T_i].min()

            if csv_path is not None:
                self._append_cem_csv(csv_path, k, out, adj, means, covs,
                                     p_mean, p_cov)

            elite_idx = np.argsort(risks)[:m_elite]
            means, covs = _cem_proposal_update(out["noises"][elite_idx],
                                               means, covs, p_mean, p_cov)
            history.append({
                "mean_risk": float(risks.mean()),
                "elite_risk": float(risks[elite_idx].mean()),
                "collision_rate": float(out["collided"].any(1).mean()),
            })
        return {"means": means, "covs": covs,
                "vars": np.stack([np.diag(c) for c in covs]),
                "history": history}


def _direct_stats(rgbs, sigmas, image):
    """(S_c2d2, S_cd, mean image, mean sigma, std sigma) of rgbs [..., S,
    3], sigmas [..., S, 1] and image [..., P], over their last dimensions."""
    cd = rgbs * sigmas
    return (torch.sum(cd ** 2, dim=(-2, -1)), torch.sum(cd, dim=(-2, -1)),
            image.mean(dim=-1), sigmas.mean(dim=(-2, -1)),
            sigmas.std(dim=(-2, -1), correction=0))


def _moment_stats(moments, image, n_samples: float):
    """The same five from frame moments [..., 4] over n_samples slots each
    and images [..., P]: mean S_d / n, std sqrt(max(S_d2 / n - mean^2,
    0))."""
    d_mean = moments[..., 2] / n_samples
    d_var = torch.clamp(moments[..., 3] / n_samples - d_mean ** 2, min=0.0)
    return (moments[..., 0], moments[..., 1], image.mean(dim=-1), d_mean,
            torch.sqrt(d_var))
