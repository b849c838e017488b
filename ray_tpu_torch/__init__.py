"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``ray_tpu``. Ported so far: the
single-node runtime core (``init``/``remote``/``get``/``put``/``wait``,
tasks, actors, the shared-memory object store with torch tensors as
first-class values, placement groups, GPUs pinned to workers through
``CUDA_VISIBLE_DEVICES`` where the reference pins TPU chips), Train on
that runtime (``train``: ``TorchTrainer`` gangs with GPU-pinned workers,
reports, checkpoints and restarts; ``air``: its configs and results), Serve
on that runtime (``serve``: deployments, handles, ``@serve.batch``,
multiplexing, streaming, the HTTP and gRPC ingress, replicas pinned to
GPUs through ``num_gpus``), the
Llama family (``models.llama``: forward, loss and gradients, remat), MoE Llama
(``models.moe_llama`` on ``ops.moe``) and ViT (``models.vit``), the
serving engine (``llm.LlamaEngine``) with LoRA folding, the LLM
configuration, a GPU actor for it and its Serve deployments
(``llm``: ``LLMServer``, ``OpenAIServer``, ``build_llm_app``,
``build_openai_app``), training on one device
(``parallel``: train state, optimizer, train and eval steps), and
hand-written sm_90a kernels for the flash-attention forward and backward
and the fused lm-head cross-entropy forward and backward (``ops``). Entry
points run on the GPU unless the caller passes ``device="cpu"``; without
a GPU they raise.

The runtime's environment variables, session, spill and scratch
directories all carry the ``RAY_TPU_TORCH_``/``ray_tpu_torch`` prefix,
so a ``ray_tpu`` runtime and this one can run side by side in one
process. Importing the package does not import torch: a runtime worker
pays for it only when it first holds a tensor.
"""

from __future__ import annotations

from . import exceptions
from ._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    free,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    timeline,
    wait,
)
from .actor import ActorClass, ActorHandle
from .job_config import JobConfig
from .object_ref import ObjectRef, ObjectRefGenerator
from .remote_function import RemoteFunction
from .runtime_context import get_runtime_context

__version__ = "0.1.0"


def remote(*args, **kwargs):
    """Turn a function into a RemoteFunction or a class into an ActorClass.

    Usable bare (`@remote`) or with options (`@remote(num_gpus=1)`).
    Parity: ray.remote (python/ray/_private/worker.py:3407).
    """

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        if callable(target):
            return RemoteFunction(target, kwargs)
        raise TypeError("@remote requires a function or class")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return wrap(args[0])
    if args:
        raise TypeError("@remote with arguments must use keyword options, e.g. @remote(num_cpus=2)")
    return wrap


def method(**kwargs):
    """Decorator for actor methods carrying default options (ray.method parity)."""

    def decorator(fn):
        fn.__ray_method_options__ = kwargs
        return fn

    return decorator


def __getattr__(name):
    # resolve_device imports torch; runtime workers that never hold a
    # tensor should not pay for that import
    if name == "resolve_device":
        from ._private.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "free",
    "get_actor",
    "available_resources",
    "cluster_resources",
    "nodes",
    "JobConfig",
    "ObjectRef",
    "ObjectRefGenerator",
    "timeline",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "get_runtime_context",
    "exceptions",
    "resolve_device",
]
