"""ray_tpu_torch.tune — hyperparameter tuning.

Parity: python/ray/tune/ (Tuner :43,312, TuneController, searchers,
schedulers, sample space). tune.report/get_checkpoint are the Train
session functions (the reference unified them the same way).
"""

from ..train.session import get_checkpoint, report
from .sample import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from .schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    OptunaSearch,
    Searcher,
)
from .tuner import ResultGrid, TuneConfig, Tuner, with_resources

__all__ = [
    "ASHAScheduler",
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "OptunaSearch",
    "PB2",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "report",
    "sample_from",
    "uniform",
    "with_resources",
]

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("tune")
