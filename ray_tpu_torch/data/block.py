"""Blocks: the unit of distributed data.

Parity: python/ray/data/block.py in the reference (Block = Arrow/pandas
table; BlockAccessor; BlockMetadata). TPU-native choice: the canonical
in-memory format is a **dict of numpy column arrays** — the exact thing
`jax.device_put` stages into HBM with zero conversion — with a row-list
fallback for arbitrary Python objects. Arrow/pandas are import/export
formats, not the hot path.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

# A Block is either a columnar batch {col -> ndarray} or a list of rows.
Block = Union[Dict[str, np.ndarray], List[Any]]


@dataclass
class BlockMetadata:
    """Parity: data/block.py BlockMetadata (num_rows, size_bytes,
    schema, input_files, exec_stats)."""

    num_rows: Optional[int] = None
    size_bytes: Optional[int] = None
    schema: Optional[Dict[str, str]] = None
    input_files: List[str] = field(default_factory=list)


def _rows_to_columns(rows: List[Any]) -> Optional[Dict[str, np.ndarray]]:
    """Try to columnarize a list of dict-rows; None if heterogeneous."""
    if not rows or not all(isinstance(r, dict) for r in rows):
        return None
    keys = list(rows[0].keys())
    if not all(list(r.keys()) == keys for r in rows):
        return None
    try:
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    except Exception:
        return None


class BlockAccessor:
    """Uniform view over both block representations
    (parity: data/block.py BlockAccessor.for_block)."""

    def __init__(self, block: Block):
        self._block = block
        self._is_columnar = isinstance(block, dict)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a UDF return (dict/ndarray/pandas/arrow/list) into a Block."""
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"data": batch}
        if batch.__class__.__module__.startswith("pandas"):
            return {c: batch[c].to_numpy() for c in batch.columns}
        if batch.__class__.__module__.startswith("pyarrow"):
            return {name: col.to_numpy(zero_copy_only=False) for name, col in zip(batch.column_names, batch.columns)}
        if isinstance(batch, list):
            cols = _rows_to_columns(batch)
            return cols if cols is not None else batch
        raise TypeError(f"cannot interpret {type(batch)} as a Block")

    # ------------------------------------------------------------ shape
    @property
    def block(self) -> Block:
        return self._block

    def num_rows(self) -> int:
        if self._is_columnar:
            if not self._block:
                return 0
            return len(next(iter(self._block.values())))
        return len(self._block)

    def size_bytes(self) -> int:
        if self._is_columnar:
            return int(sum(v.nbytes for v in self._block.values()))
        return int(sum(sys.getsizeof(r) for r in self._block))

    def schema(self) -> Optional[Dict[str, str]]:
        if self._is_columnar:
            return {k: str(v.dtype) for k, v in self._block.items()}
        if self._block:
            return {"item": type(self._block[0]).__name__}
        return None

    def metadata(self, input_files: Optional[List[str]] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=list(input_files or []),
        )

    # ------------------------------------------------------- row access
    def iter_rows(self) -> Iterator[Any]:
        if self._is_columnar:
            keys = list(self._block.keys())
            for i in range(self.num_rows()):
                yield {k: self._block[k][i] for k in keys}
        else:
            yield from self._block

    def slice(self, start: int, end: int) -> Block:
        if self._is_columnar:
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]

    def take(self, indices: np.ndarray) -> Block:
        if self._is_columnar:
            return {k: v[indices] for k, v in self._block.items()}
        return [self._block[i] for i in indices]

    # ------------------------------------------------------ conversions
    def to_batch(self, batch_format: str = "numpy") -> Any:
        if batch_format in ("numpy", "default"):
            if self._is_columnar:
                return dict(self._block)
            cols = _rows_to_columns(self._block)
            return cols if cols is not None else self._block
        if batch_format == "pandas":
            import pandas as pd

            if self._is_columnar:
                return pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in self._block.items()})
            return pd.DataFrame(self._block)
        if batch_format == "pyarrow":
            import pyarrow as pa

            if self._is_columnar:
                return pa.table({k: pa.array(list(v)) if v.ndim > 1 else pa.array(v) for k, v in self._block.items()})
            return pa.table({"item": self._block})
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def to_pandas(self):
        return self.to_batch("pandas")

    def to_arrow(self):
        return self.to_batch("pyarrow")

    # --------------------------------------------------------- combine
    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        nonempty = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not nonempty:
            # preserve columnar schema of empty inputs rather than
            # degrading to a row-list (downstream UDFs index columns)
            return blocks[0] if blocks else []
        blocks = nonempty
        if all(isinstance(b, dict) for b in blocks):
            keys = list(blocks[0].keys())
            return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
        rows: List[Any] = []
        for b in blocks:
            rows.extend(BlockAccessor(b).iter_rows())
        return rows

    def sort_indices(self, key: Union[str, Any], descending: bool = False) -> np.ndarray:
        if callable(key):
            vals = np.asarray([key(r) for r in self.iter_rows()])
        elif self._is_columnar:
            vals = self._block[key]
        else:
            vals = np.asarray([r[key] for r in self._block])
        idx = np.argsort(vals, kind="stable")
        return idx[::-1] if descending else idx
