"""Config loading and logging: the port's own copy of ``ttamm_tpu/utils``
(without the XLA compile cache)."""

from .config import (
    clone_config,
    expand_grid,
    get_by_dotted_path,
    load_config,
    set_by_dotted_path,
)
from .logging import configure_logging, get_logger

__all__ = [
    "clone_config",
    "configure_logging",
    "expand_grid",
    "get_by_dotted_path",
    "get_logger",
    "load_config",
    "set_by_dotted_path",
]
