"""Host-side data prep (numpy and pandas): the port's own copy of
``ttamm_tpu/data`` (loaders, features, index mappings, preprocessing,
splits, packing and the synthetic corpus generator), same names and
behaviour."""

from .arrays import (
    ItemCategories,
    PaddedPositives,
    build_item_categories,
    interaction_arrays,
    pack_positives,
    positives_from_frame,
)
from .features import (
    FeatureMetadata,
    build_item_feature_matrix,
    build_user_feature_matrix,
    parse_category_tokens,
)
from .indexers import IndexMapping, build_index_mapping
from .loaders import DatasetArtifacts, load_books, load_dataset, load_interactions
from .preprocessing import TrainingDataset, build_training_dataset
from .splits import split_train_validation, split_train_validation_test
from .synthetic import CANONICAL_CORPUS, write_synthetic_csvs

__all__ = [
    "CANONICAL_CORPUS",
    "DatasetArtifacts",
    "FeatureMetadata",
    "IndexMapping",
    "ItemCategories",
    "PaddedPositives",
    "TrainingDataset",
    "build_index_mapping",
    "build_item_categories",
    "build_item_feature_matrix",
    "build_training_dataset",
    "build_user_feature_matrix",
    "interaction_arrays",
    "load_books",
    "load_dataset",
    "load_interactions",
    "pack_positives",
    "parse_category_tokens",
    "positives_from_frame",
    "split_train_validation",
    "split_train_validation_test",
    "write_synthetic_csvs",
]
