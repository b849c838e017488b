"""Fit/transform preprocessors over Datasets.

Parity: python/ray/data/preprocessors/ (Preprocessor ABC in
preprocessor.py; scalers.py StandardScaler/MinMaxScaler, encoders.py
OneHotEncoder/LabelEncoder, concatenator.py, chain.py, imputer.py).
Stats are computed with one pass of the Dataset's own aggregation plan
(columnar-numpy blocks), and transforms are plain ``map_batches``
stages — they fuse with neighbouring operators like any other map.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .aggregate import Max, Mean, Min, Std
from .dataset import Dataset


class Preprocessor:
    """fit/transform over Datasets + single-batch transform_batch.

    Subclasses implement ``_fit(ds) -> stats dict`` and
    ``_transform_batch(batch) -> batch``.
    """

    # reference: preprocessor.py Preprocessor.fit_status
    _is_fittable = True

    def __init__(self):
        self.stats_: Optional[Dict[str, Any]] = None

    def fit(self, ds: Dataset) -> "Preprocessor":
        if self._is_fittable:
            self.stats_ = self._fit(ds)
        return self

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    def transform(self, ds: Dataset) -> Dataset:
        self._check_fitted()
        return ds.map_batches(self._transform_batch)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self._check_fitted()
        return self._transform_batch(dict(batch))

    def _check_fitted(self) -> None:
        if self._is_fittable and self.stats_ is None:
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform"
            )

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        raise NotImplementedError

    def _transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(stats={self.stats_})"


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference scalers.py StandardScaler)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        aggs = []
        for c in self.columns:
            aggs += [Mean(c), Std(c)]
        out = ds.aggregate(*aggs)
        return {
            c: (out[f"mean({c})"], out[f"std({c})"] or 1.0) for c in self.columns
        }

    def _transform_batch(self, batch):
        for c in self.columns:
            mean, std = self.stats_[c]
            batch[c] = (np.asarray(batch[c], np.float64) - mean) / (std or 1.0)
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (reference MinMaxScaler)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        aggs = []
        for c in self.columns:
            aggs += [Min(c), Max(c)]
        out = ds.aggregate(*aggs)
        return {c: (out[f"min({c})"], out[f"max({c})"]) for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) or 1.0
            batch[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return batch


def _collect_uniques(ds: Dataset, columns: List[str]) -> Dict[str, np.ndarray]:
    """One pass: per-block uniques, unioned on the driver."""

    def block_uniques(batch):
        uniques = {c: np.unique(batch[c]) for c in columns}
        n = max(len(u) for u in uniques.values())
        out = {}
        for c, u in uniques.items():
            # pad so all columns align into one rectangular block
            pad = np.full(n - len(u), u[-1] if len(u) else 0, dtype=u.dtype)
            out["u_" + c] = np.concatenate([u, pad]) if len(u) else u
        return out

    uniques: Dict[str, List[np.ndarray]] = {c: [] for c in columns}
    for batch in ds.map_batches(block_uniques).iter_batches():
        for c in columns:
            uniques[c].append(np.asarray(batch["u_" + c]))
    return {
        c: np.unique(np.concatenate(v)) if v else np.asarray([])
        for c, v in uniques.items()
    }


class OneHotEncoder(Preprocessor):
    """Expand a categorical column into 0/1 indicator columns
    (reference encoders.py OneHotEncoder: output column ``{col}_{val}``)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        return {c: list(u) for c, u in _collect_uniques(ds, self.columns).items()}

    def _transform_batch(self, batch):
        for c in self.columns:
            vals = np.asarray(batch.pop(c))
            for cat in self.stats_[c]:
                batch[f"{c}_{cat}"] = (vals == cat).astype(np.int8)
        return batch


class LabelEncoder(Preprocessor):
    """Map categorical labels to contiguous ints (reference LabelEncoder)."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        uniques = _collect_uniques(ds, [self.label_column])[self.label_column]
        return {"classes": list(uniques)}

    def _transform_batch(self, batch):
        classes = np.asarray(self.stats_["classes"])
        vals = np.asarray(batch[self.label_column])
        idx = np.searchsorted(classes, vals)
        # validate (searchsorted gives wrong idx silently for unseen)
        bad = (idx >= len(classes)) | (classes[np.clip(idx, 0, len(classes) - 1)] != vals)
        if bad.any():
            raise ValueError(
                f"unseen labels in {self.label_column!r}: "
                f"{np.unique(vals[bad])[:5]}"
            )
        batch[self.label_column] = idx.astype(np.int64)
        return batch


class SimpleImputer(Preprocessor):
    """Fill NaNs with the column mean or a constant (reference imputer.py)."""

    def __init__(self, columns: List[str], strategy: str = "mean", fill_value=None):
        super().__init__()
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unsupported strategy {strategy!r}")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        if strategy == "constant":
            self._is_fittable = False

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        # NaN-aware mean: aggregate sum/count over the non-NaN entries
        def nan_stats(batch):
            return {
                f"s_{c}": np.asarray([np.nansum(np.asarray(batch[c], np.float64))])
                for c in self.columns
            } | {
                f"n_{c}": np.asarray(
                    [np.count_nonzero(~np.isnan(np.asarray(batch[c], np.float64)))]
                )
                for c in self.columns
            }

        sums = {c: 0.0 for c in self.columns}
        counts = {c: 0 for c in self.columns}
        for batch in ds.map_batches(nan_stats).iter_batches():
            for c in self.columns:
                sums[c] += float(np.sum(batch[f"s_{c}"]))
                counts[c] += int(np.sum(batch[f"n_{c}"]))
        return {c: (sums[c] / counts[c] if counts[c] else 0.0) for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            vals = np.asarray(batch[c], np.float64)
            fill = (
                self.fill_value if self.strategy == "constant" else self.stats_[c]
            )
            batch[c] = np.where(np.isnan(vals), fill, vals)
        return batch


class Concatenator(Preprocessor):
    """Pack feature columns into one 2-D float column (reference
    concatenator.py — the step that makes batches model-ready)."""

    _is_fittable = False

    def __init__(
        self,
        columns: List[str],
        output_column_name: str = "concat_out",
        dtype=np.float32,
    ):
        super().__init__()
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _transform_batch(self, batch):
        parts = []
        for c in self.columns:
            v = np.asarray(batch.pop(c), self.dtype)
            parts.append(v.reshape(len(v), -1))
        batch[self.output_column_name] = np.concatenate(parts, axis=1)
        return batch


class Chain(Preprocessor):
    """Run preprocessors in sequence; fit stages on the progressively
    transformed dataset (reference chain.py semantics)."""

    def __init__(self, *stages: Preprocessor):
        super().__init__()
        self.stages = list(stages)

    def fit(self, ds: Dataset) -> "Chain":
        for stage in self.stages:
            ds = stage.fit_transform(ds)
        self.stats_ = {"fitted": True}
        return self

    def transform(self, ds: Dataset) -> Dataset:
        self._check_fitted()
        for stage in self.stages:
            ds = stage.transform(ds)
        return ds

    def transform_batch(self, batch):
        self._check_fitted()
        for stage in self.stages:
            batch = stage.transform_batch(batch)
        return batch


__all__ = [
    "Preprocessor",
    "StandardScaler",
    "MinMaxScaler",
    "OneHotEncoder",
    "LabelEncoder",
    "SimpleImputer",
    "Concatenator",
    "Chain",
]
