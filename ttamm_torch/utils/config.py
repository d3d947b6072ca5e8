"""YAML configuration handling: load, deep-clone, dotted-path access, sweeps.

Capability parity with the reference config system
(``src/utils/config.py:12-63`` and the sweep expansion in
``src/pipelines/training.py:1857-1879``): a single nested-dict config loaded
from YAML, mutated via dotted paths, and expanded into Cartesian-product
experiment grids.
"""

from __future__ import annotations

import copy
from itertools import product
from pathlib import Path
from typing import Any, Iterator, Mapping, MutableMapping, Sequence

import yaml


def load_config(config_path: Path | str) -> dict[str, Any]:
    """Parse a YAML file into a nested dict. Raises FileNotFoundError when absent."""
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f"Configuration file not found: {config_path}")
    with config_path.open("r", encoding="utf-8") as handle:
        return yaml.safe_load(handle) or {}


def clone_config(config: Mapping[str, Any]) -> dict[str, Any]:
    """Deep copy of the configuration mapping."""
    return copy.deepcopy(config)


def set_by_dotted_path(
    config: MutableMapping[str, Any], dotted_key: str, value: Any
) -> None:
    """Assign ``value`` at ``dotted_key`` (e.g. ``training.learning_rate``),
    creating intermediate dicts as needed."""
    keys: Sequence[str] = dotted_key.split(".")
    current: MutableMapping[str, Any] = config
    for key in keys[:-1]:
        if key not in current or not isinstance(current[key], MutableMapping):
            current[key] = {}
        current = current[key]
    current[keys[-1]] = value


def get_by_dotted_path(
    config: Mapping[str, Any], dotted_key: str, default: Any = None
) -> Any:
    """Fetch the value at ``dotted_key`` or ``default`` when any level is missing."""
    current: Any = config
    for key in dotted_key.split("."):
        if not isinstance(current, Mapping) or key not in current:
            return default
        current = current[key]
    return current


def expand_grid(
    config: Mapping[str, Any], grid: Mapping[str, Sequence[Any]]
) -> Iterator[tuple[dict[str, Any], dict[str, Any]]]:
    """Yield ``(run_config, overrides)`` for every point of the Cartesian
    product of ``grid`` (a mapping of dotted path -> list of values).

    Run names follow the reference convention ``{base}_sweepNN``
    (``src/pipelines/training.py:1868-1876``).
    """
    keys = list(grid.keys())
    base_name = str(get_by_dotted_path(config, "experiment.name", "experiment"))
    for idx, combination in enumerate(product(*[grid[key] for key in keys])):
        overrides = dict(zip(keys, combination))
        run_config = clone_config(config)
        for key, value in overrides.items():
            set_by_dotted_path(run_config, key, value)
        run_config.setdefault("experiment", {})
        run_config["experiment"]["name"] = f"{base_name}_sweep{idx:02d}"
        yield run_config, overrides
