"""Raw-ID <-> contiguous-index mappings, first-appearance ordered.

Capability parity with the reference's indexer module
(``src/data/indexers.py:15-56``). First-appearance order matters: it pins
which raw ID owns which embedding row, making runs reproducible and
letting sharded tables assign contiguous row ranges per shard.

The mapping stores the ordered vocabulary once; the reverse dict is built
lazily on first keyed lookup (the hot paths — preprocessing, report
writers — only ever walk ``index_to_id``, so 2M-row mappings skip the
dict build entirely).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import pandas as pd


class IndexMapping:
    """Bidirectional mapping between raw IDs and contiguous indices."""

    __slots__ = ("index_to_id", "_reverse")

    def __init__(
        self,
        index_to_id: Sequence[str] | None = None,
        *,
        id_to_index: dict[str, int] | None = None,
    ) -> None:
        if index_to_id is None:
            if id_to_index is None:
                raise ValueError("IndexMapping needs a vocabulary")
            ordered = sorted(id_to_index.items(), key=lambda kv: kv[1])
            index_to_id = [k for k, _ in ordered]
        self.index_to_id = list(index_to_id)
        self._reverse = id_to_index

    @classmethod
    def from_uniques(cls, uniques: Iterable) -> "IndexMapping":
        return cls([str(v) for v in uniques])

    def _dict(self) -> dict[str, int]:
        if self._reverse is None:
            self._reverse = {
                v: i for i, v in enumerate(self.index_to_id)
            }
        return self._reverse

    @property
    def id_to_index(self) -> dict[str, int]:
        return self._dict()

    def __len__(self) -> int:
        return len(self.index_to_id)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, IndexMapping)
            and self.index_to_id == other.index_to_id
        )

    def to_index(self, raw_id: str) -> int:
        found = self._dict().get(raw_id)
        if found is None:
            raise KeyError(f"ID '{raw_id}' missing from index mapping")
        return found

    def to_id(self, index: int) -> str:
        if not 0 <= index < len(self.index_to_id):
            raise IndexError(f"Index {index} out of bounds for mapping")
        return self.index_to_id[index]


def build_index_mapping(values: Iterable[str]) -> IndexMapping:
    """Create an IndexMapping preserving order of first appearance.

    One vectorized path for every input kind: ``pd.factorize`` returns
    uniques in first-appearance order (what the reference's Python loop
    produced) at C speed over millions of rows.
    """
    if not isinstance(values, (pd.Series, pd.Index, np.ndarray)):
        values = np.asarray(list(values), dtype=object)
    _, uniques = pd.factorize(np.asarray(values), use_na_sentinel=False)
    return IndexMapping.from_uniques(np.asarray(uniques))
