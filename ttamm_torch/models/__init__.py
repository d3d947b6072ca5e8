from .adaptive_mimic import MimicTables, augment, mimic_forward
from .convert import from_jax_checkpoint, from_jax_params
from .encoders import (
    EmbeddingConfig,
    FeatureEncoderConfig,
    Tower,
    TowerConfig,
    parse_tower_config,
)
from .two_tower import ModelConfig, TwoTower, parse_model_config, similarity_scores

__all__ = [
    "EmbeddingConfig",
    "FeatureEncoderConfig",
    "MimicTables",
    "ModelConfig",
    "Tower",
    "TowerConfig",
    "TwoTower",
    "augment",
    "from_jax_checkpoint",
    "from_jax_params",
    "mimic_forward",
    "parse_model_config",
    "parse_tower_config",
    "similarity_scores",
]
