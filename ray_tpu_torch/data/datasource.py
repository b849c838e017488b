"""Datasources: pluggable readers producing ReadTasks.

Parity: python/ray/data/datasource/ + read_api.py in the reference
(Datasource ABC, ReadTask = zero-arg callable returning blocks +
metadata estimate). Each ReadTask is shipped to a worker by the
streaming executor; IO happens inside tasks, never on the driver.
"""

from __future__ import annotations

import glob as globmod
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from .block import Block, BlockAccessor, BlockMetadata


@dataclass
class ReadTask:
    """A zero-arg callable returning an iterable of Blocks."""

    read_fn: Callable[[], Iterable[Block]]
    metadata: BlockMetadata


class Datasource:
    """Parity: data/datasource/datasource.py Datasource ABC."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class RangeDatasource(Datasource):
    def __init__(self, n: int, block_format: str = "column"):
        self.n = n
        self.block_format = block_format

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n, k = self.n, max(1, min(parallelism, self.n or 1))
        sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
        tasks, start = [], 0
        for sz in sizes:
            lo, hi = start, start + sz
            start = hi
            if self.block_format == "column":
                fn = lambda lo=lo, hi=hi: [{"id": np.arange(lo, hi)}]
            else:
                fn = lambda lo=lo, hi=hi: [list(range(lo, hi))]
            tasks.append(ReadTask(fn, BlockMetadata(num_rows=sz)))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n, k = len(self.items), max(1, min(parallelism, len(self.items) or 1))
        sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
        tasks, start = [], 0
        for sz in sizes:
            chunk = self.items[start : start + sz]
            start += sz
            cols = BlockAccessor.batch_to_block(chunk)
            tasks.append(
                ReadTask(
                    lambda c=cols: [c], BlockMetadata(num_rows=sz)
                )
            )
        return tasks


class NumpyDatasource(Datasource):
    def __init__(self, arrays: List[np.ndarray], column: str = "data"):
        self.arrays = arrays
        self.column = column

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [
            ReadTask(
                lambda a=a, c=self.column: [{c: a}],
                BlockMetadata(num_rows=len(a), size_bytes=a.nbytes),
            )
            for a in self.arrays
        ]


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            # recursive walk, files only (hive-style partition dirs etc.)
            found = []
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
                found.extend(
                    os.path.join(root, f)
                    for f in files
                    if not f.startswith((".", "_"))
                )
            out.extend(sorted(found))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globmod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files found for {paths}")
    return out


class FileBasedDatasource(Datasource):
    """One ReadTask per file group (parity:
    data/datasource/file_based_datasource.py)."""

    def __init__(self, paths):
        self.paths = _expand_paths(paths)

    def _read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        k = max(1, min(parallelism, len(self.paths)))
        groups: List[List[str]] = [[] for _ in range(k)]
        for i, p in enumerate(self.paths):
            groups[i % k].append(p)

        def make(group):
            def read():
                return [self._read_file(p) for p in group]

            return read

        return [
            ReadTask(make(g), BlockMetadata(input_files=g))
            for g in groups
            if g
        ]


class ParquetDatasource(FileBasedDatasource):
    def __init__(self, paths, columns: Optional[List[str]] = None):
        super().__init__(paths)
        self.columns = columns

    def _read_file(self, path: str) -> Block:
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=self.columns)
        return BlockAccessor.batch_to_block(table)


class CSVDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        import pyarrow.csv as pacsv

        return BlockAccessor.batch_to_block(pacsv.read_csv(path))


class JSONDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        import json

        rows = []
        with open(path) as f:
            text = f.read().strip()
        if text.startswith("["):
            rows = json.loads(text)
        else:  # jsonl
            rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        return BlockAccessor.batch_to_block(rows)


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        return [{"path": path, "bytes": data}]


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": np.asarray(lines, dtype=object)}
