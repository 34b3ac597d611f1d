"""Network configuration: the fields of the JAX package's `NetworkConfig`
(nerfsafetyvalidation_tpu/config.py) that the ported paths read, and
`network_config_from_opt`, which builds one from the CLI's flags; and
`EnvConfig`, the validation job's envConfig.json schema with the JAX
package's defaults."""

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass(frozen=True)
class NetworkConfig:
    encoding: str = "hashgrid"  # hashgrid|tiledgrid|frequency|None|mipfold
    encoding_dir: str = "sphere_harmonics"
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    bound: float = 1.0
    # position-encoder grid (mipfold: scales base * 2^l for l < num_levels,
    # dense up to fold_max_scale, hashed above it)
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None   # None -> 2048 * bound
    align_corners: bool = False
    aligned_levels: bool = False        # power-of-two levels (not ported)
    fold_max_scale: int = 128
    fold_scale: int = 0                 # 0: fold at the native dense scale
    sh_degree: int = 4
    multires: int = 6                   # frequency encoding degree
    density_scale: float = 1.0
    min_near: float = 0.2
    density_thresh: float = 0.01
    bg_radius: float = -1.0             # > 0: the background net
    grid_ray: bool = False              # train through the occupancy march
    grid_size: int = 128
    compute_dtype: str = "float32"      # 'float32' | 'bfloat16'
    fused: bool = False                 # route apply through the MLP kernel
    # mipfold training dense fetch: 'corner8' | 'foldrow' | 'foldrow_pallas'
    # (the same function; 'foldrow_pallas' folds through kernel K5)
    train_gather: str = "corner8"
    # hashgrid: encode only levels < max_level (the rest encode to zero);
    # None keeps every level
    max_level: Optional[int] = None

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @property
    def grid_resolution(self) -> int:
        return int(2048 * self.bound) if self.desired_resolution is None \
            else self.desired_resolution


def network_config_from_opt(opt) -> NetworkConfig:
    """A NetworkConfig from an argparse-style namespace with the reference
    CLI's flags (the JAX package's config.py:168-187): `--cuda_ray` marches
    (grid_ray), `--fp16` computes in bfloat16, `--ff` (or `--tcnn`) sets
    `fused`. Which net the flags build, and in which dtype, is
    `models.make_network(cfg, params, opt=opt)`'s: `--ff` forces bfloat16."""
    extra = {}
    if getattr(opt, "encoding", "hashgrid") == "mipfold":
        # the mip-fold backbone's defaults: 8 power-of-two scales
        # 16..2048, 4 channels each
        extra = dict(num_levels=8, level_dim=4, aligned_levels=True)
    return NetworkConfig(
        encoding=getattr(opt, "encoding", "hashgrid"),
        bound=opt.bound,
        **extra,
        density_scale=1.0,
        min_near=opt.min_near,
        density_thresh=opt.density_thresh,
        bg_radius=opt.bg_radius,
        grid_ray=getattr(opt, "cuda_ray", False),
        compute_dtype="bfloat16" if getattr(opt, "fp16", False)
        else "float32",
        fused=getattr(opt, "ff", False) or getattr(opt, "tcnn", False),
    )


@dataclass
class EnvConfig:
    """The validation job's config (envConfig.json): the JAX package's
    `EnvConfig` (config.py:123-160), the same keys and defaults."""
    simulator: str = "NerfSimulator"
    stress_test: str = "Monte Carlo"
    uq_method: str = "Gaussian Approximation"
    n_simulations: int = 100
    estimator_cfg: dict = field(default_factory=lambda: {
        "dil_iter": 3, "kernel_size": 5, "batch_size": 1024, "lrate": 1e-3,
        "N_iter": 100, "render_viz": False, "show_rate": [20, 100]})
    agent_cfg: dict = field(default_factory=lambda: {
        "body_lims": [[-0.05, 0.05], [-0.05, 0.05], [-0.02, 0.02]],
        "body_nbins": [10, 10, 5], "mass": 1.0, "g": 10.0,
        "I": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        "path": "./sim_img_cache", "blend_file": "stonehenge.blend"})
    planner_cfg: dict = field(default_factory=lambda: {
        "x_range": [-1.15, 0.8], "y_range": [-1.2, 0.9],
        "z_range": [0.05, 0.45],
        "start_pos": [-0.75, -0.235, 0.25], "end_pos": [0.2, -0.74, 0.3],
        "start_R": [0.0, 0.0, 0.0], "end_R": [0.0, 0.0, 0.0],
        "T_final": 2.0, "steps": 12, "planner_lr": 0.001,
        "epochs_init": 1000, "fade_out_epoch": 0, "fade_out_sharpness": 10,
        "epochs_update": 250})
    mpc_cfg: dict = field(default_factory=lambda: {
        "mpc_noise_mean": [0.0] * 12,
        "mpc_noise_std": [2e-2] * 3 + [1e-2] * 3 + [2e-2] * 3 + [1e-2] * 3})
    camera_cfg: dict = field(default_factory=lambda: {
        "half_res": False, "white_bg": True, "res_x": 800, "res_y": 800,
        "trans": True, "mode": "RGBA"})

    @staticmethod
    def load(path: str = "envConfig.json") -> "EnvConfig":
        """The file's top-level keys replace the defaults (whole values);
        unknown keys are ignored."""
        with open(path) as f:
            raw = json.load(f)
        cfg = EnvConfig()
        for k, v in raw.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)
