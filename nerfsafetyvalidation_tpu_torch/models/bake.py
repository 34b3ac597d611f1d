"""Student configuration of the baked field (nerfsafetyvalidation_tpu/
models/bake.py `student_config`). Distillation is not ported yet."""

from dataclasses import replace

from ..config import NetworkConfig


def student_config(teacher_cfg: NetworkConfig, multires: int = 10,
                   hidden_dim: int = 128, num_layers: int = 4,
                   hidden_dim_color: int = 64) -> NetworkConfig:
    """Frequency-encoded MLP student of a teacher configuration."""
    return replace(teacher_cfg, encoding="frequency", multires=multires,
                   num_layers=num_layers, hidden_dim=hidden_dim,
                   hidden_dim_color=hidden_dim_color, fused=False)
