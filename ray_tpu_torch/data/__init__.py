"""ray_tpu_torch.data — distributed datasets for GPU pipelines.

Parity: python/ray/data/ in the reference (Dataset, read_api,
aggregate, ActorPoolStrategy, DataContext). Columnar-numpy blocks,
lazy logical plans, a streaming task/actor-pool executor with GPUs
pinned to its tasks and pool actors, and batch staging into device
memory through torch. See dataset.py for the surface.
"""

from .aggregate import AbsMax, AggregateFn, Count, Max, Mean, Min, Std, Sum
from .block import Block, BlockAccessor, BlockMetadata
from .context import DataContext
from .dataset import (
    ActorPoolStrategy,
    Dataset,
    GroupedData,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from .datasource import Datasource, ReadTask
from . import preprocessors

__all__ = [
    "AbsMax", "ActorPoolStrategy", "AggregateFn", "Block", "BlockAccessor",
    "BlockMetadata", "Count", "DataContext", "Dataset", "Datasource",
    "GroupedData", "Max", "Mean", "Min", "ReadTask", "Std", "Sum",
    "from_arrow", "from_items", "from_numpy", "from_pandas", "range",
    "read_binary_files", "read_csv", "read_datasource", "read_images",
    "read_json", "read_numpy", "read_parquet", "read_text", "read_tfrecords",
    "read_webdataset",
]

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("data")
