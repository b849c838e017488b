"""LLM serving: continuous-batching deployment over ray_tpu_torch.serve.

Parity: python/ray/llm/_internal/serve/deployments/llm/ (VLLMService +
build_openai_app) — the engine is the in-tree Llama with a preallocated
KV cache on the card (llm/_internal/engine.py), not a wrapped vLLM;
requests stream tokens through the serve streaming-response path
(handle.options(stream=True) over num_returns="streaming").

Device: the parameters load onto ``engine_kwargs.get("device")`` (None
is the GPU, which the replica's ``num_gpus`` pins; "cpu" asks for the
CPU), and the base engine and every LoRA engine run there.

HTTP: `serve.run(build_llm_app(cfg))` exposes POST /<name> with JSON
{"prompt_ids": [...], "max_tokens": N, "temperature": t, "stream": bool}
via the existing serve proxy.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from .config import LLMConfig


class LLMServer:
    """Deployment class: one engine + a background continuous-batching
    loop; concurrent callers enqueue and stream tokens out."""

    def __init__(self, llm_config: LLMConfig):
        self.config = llm_config
        params = llm_config.load_params(llm_config.engine_kwargs.get("device"))
        from ._internal.engine import LlamaEngine

        from ray_tpu_torch.models import llama

        self._base_params = params
        self._model_config = llm_config.model_config or llama.LLAMA_TINY
        self.engine = LlamaEngine(
            self._model_config,
            params,
            max_batch=llm_config.max_batch_size,
            max_seq=llm_config.max_seq_len,
            **llm_config.engine_kwargs,
        )
        # LoRA multiplexing: adapter id -> folded-weights engine, LRU-
        # capped (never evicting active engines — which is why this is
        # a hand-rolled cache rather than @serve.multiplexed); loaded
        # ids ride the serve multiplex registry so the router prefers
        # replicas already holding an adapter
        from collections import OrderedDict

        self._engines: "OrderedDict[str, LlamaEngine]" = OrderedDict()
        self._loading: set = set()  # adapter ids mid-cold-load (cap slots)
        self._engines[""] = self.engine
        self._engines_lock = threading.Lock()
        self._reporter = None
        if llm_config.lora_config:
            from ray_tpu_torch.serve.multiplex import register_model_reporter

            self._reporter = register_model_reporter(self._loaded_adapters)
        self._pending: "queue.Queue" = queue.Queue()
        self._id_counter = itertools.count()
        self._token_queues: Dict[str, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._running = True
        self._loop_thread = threading.Thread(
            target=self._batching_loop, daemon=True, name="llm-batching"
        )
        self._loop_thread.start()

    # -- LoRA engines --------------------------------------------------
    def _loaded_adapters(self):
        with self._engines_lock:
            return [aid for aid in self._engines if aid]

    def shutdown(self) -> None:
        """Stop the batching loop and drop the multiplex registration.
        Must be called explicitly for in-process servers: the batching
        thread and the multiplex registry hold strong refs, so __del__
        would never fire (Serve replicas die with their actor process,
        which achieves the same)."""
        self._running = False
        if self._reporter is not None:
            from ray_tpu_torch.serve.multiplex import unregister_model_reporter

            unregister_model_reporter(self._reporter)
            self._reporter = None

    def _engine_for(self, adapter_id: str):
        """Engine serving this adapter, loading + folding on first use
        (LRU-capped per lora_config.max_adapters_per_replica).

        Callers invoke this at SUBMISSION time (their own thread) so a
        cold load — disk read + fold + KV-cache alloc + first
        forward — never stalls the batching loop's token emission for
        other requests; the loop only re-resolves on the rare
        submitted-then-evicted race."""
        with self._engines_lock:
            eng = self._engines.get(adapter_id)
            if eng is not None:
                self._engines.move_to_end(adapter_id)
                return eng
        lora = self.config.lora_config
        if not lora:
            raise ValueError(
                f"request for adapter {adapter_id!r} but no lora_config"
            )
        import os

        if (
            not adapter_id
            or "/" in adapter_id
            or "\\" in adapter_id
            or ".." in adapter_id
        ):
            # the id comes from request bodies: it must never be able to
            # escape dynamic_lora_loading_path
            raise ValueError(f"invalid adapter id {adapter_id!r}")

        cap = int(lora.get("max_adapters_per_replica", 4))
        with self._engines_lock:
            # HARD cap: when every loaded adapter is mid-generation and
            # the cap is reached, refuse — an unbounded engine pile-up
            # (full KV cache each) OOMs the replica. In-flight loads
            # count via the _loading placeholder set, closing the
            # check-then-act window (the load itself runs unlocked for
            # seconds).
            busy = [
                aid for aid in self._engines
                if aid and self._engines[aid].num_active()
            ]
            if len(busy) + len(self._loading) >= cap:
                raise RuntimeError(
                    f"all {cap} adapter slots are busy; retry later "
                    "(max_adapters_per_replica)"
                )
            self._loading.add(adapter_id)

        try:
            from ._internal.engine import LlamaEngine
            from .lora import apply_lora, load_lora_adapter

            base = lora["dynamic_lora_loading_path"]
            path = (
                base.format(adapter_id)
                if "{}" in base
                else os.path.join(base, adapter_id + ".npz")
            )
            folded = apply_lora(
                self._base_params,
                load_lora_adapter(path),
                scale=float(lora.get("scale", 1.0)),
            )
            eng = LlamaEngine(
                self._model_config,
                folded,
                max_batch=self.config.max_batch_size,
                max_seq=self.config.max_seq_len,
                **self.config.engine_kwargs,
            )
        finally:
            with self._engines_lock:
                self._loading.discard(adapter_id)
        with self._engines_lock:
            existing = self._engines.get(adapter_id)
            if existing is not None:  # lost a racing load of the same id
                return existing
            self._engines[adapter_id] = eng
            # LRU-evict idle adapters past the cap — never the base "",
            # never an engine mid-generation, never the one just loaded
            evictable = [
                aid for aid in self._engines
                if aid and aid != adapter_id
                and not self._engines[aid].num_active()
            ]
            while len(self._engines) - 1 > cap and evictable:
                del self._engines[evictable.pop(0)]
        return eng

    # -- continuous batching loop -------------------------------------
    def _batching_loop(self):
        while self._running:
            # admit as many pending requests as their engines have slots
            admitted = False
            requeue = []
            while True:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                q = self._token_queues.get(req.request_id)
                try:
                    eng = self._engine_for(req.adapter_id)
                except Exception as e:
                    if q is not None:
                        q.put(("error", e))
                    continue
                if not eng.has_capacity():
                    requeue.append(req)
                    continue
                try:
                    ok = eng.add_request(req)
                except Exception as e:
                    # a bad request (e.g. prompt >= max_seq) must fail
                    # its own caller, never the batching thread
                    if q is not None:
                        q.put(("error", e))
                    continue
                if ok is False:
                    # no slot after all (has_capacity raced a concurrent
                    # admit): retry next loop instead of dropping the
                    # request on the floor
                    requeue.append(req)
                    continue
                admitted = True
                # the first token arrives from step() once the chunked
                # prefill completes — nothing to emit at admission
            for req in requeue:
                self._pending.put(req)
            stepped = False
            with self._engines_lock:
                live_engines = list(self._engines.values())
            for eng in live_engines:
                if not eng.num_active():
                    continue
                stepped = True
                try:
                    emitted = eng.step()
                except Exception as e:
                    # engine fault: fail every in-flight request, keep serving
                    for req in eng.abort_all():
                        q = self._token_queues.get(req.request_id)
                        if q is not None:
                            q.put(("error", e))
                    continue
                # a step may emit two tokens of one request (its prompt's
                # last chunk, then a decode): "done" follows its last one
                last = {id(req): i for i, (req, _) in enumerate(emitted)}
                for i, (req, tok) in enumerate(emitted):
                    q = self._token_queues.get(req.request_id)
                    if q is not None:
                        q.put(("token", tok))
                        if req.done and last[id(req)] == i:
                            q.put(("done", None))
            if not stepped and not admitted:
                time.sleep(0.005)

    # -- request entrypoints ------------------------------------------
    def generate_stream(
        self,
        prompt_ids: List[int],
        max_tokens: int = 64,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        adapter_id: Optional[str] = None,
    ):
        """Generator: yields token ids as the engine produces them
        (invoked through serve's streaming path)."""
        from ._internal.engine import GenRequest

        if adapter_id is None:
            # serve routing: handle.options(multiplexed_model_id=...)
            from ray_tpu_torch.serve import get_multiplexed_model_id

            adapter_id = get_multiplexed_model_id()
        if adapter_id:
            # cold-load in THIS thread (see _engine_for docstring): load
            # errors also surface here, at submission, with a stack
            self._engine_for(adapter_id)
        rid = f"req{next(self._id_counter)}"
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._token_queues[rid] = q
        self._pending.put(
            GenRequest(
                request_id=rid,
                prompt_ids=list(prompt_ids),
                max_tokens=max_tokens,
                temperature=temperature,
                eos_id=eos_id,
                adapter_id=adapter_id or "",
            )
        )
        try:
            while True:
                kind, tok = q.get(timeout=120)
                if kind == "done":
                    return
                if kind == "error":
                    raise tok
                yield tok
        finally:
            with self._lock:
                self._token_queues.pop(rid, None)

    def generate(self, prompt_ids, max_tokens=64, temperature=0.0,
                 eos_id=None, adapter_id=None) -> List[int]:
        return list(
            self.generate_stream(
                prompt_ids, max_tokens, temperature, eos_id, adapter_id
            )
        )

    def __call__(self, request: Dict[str, Any]):
        """Entrypoint for both direct handle calls ({"prompt_ids": ...})
        and the serve HTTP proxy (request dict with a raw JSON body)."""
        if "prompt_ids" not in request and request.get("body"):
            import json

            request = json.loads(request["body"])
        prompt_ids = request.get("prompt_ids")
        if prompt_ids is None:
            raise ValueError("request must contain 'prompt_ids'")
        # "model" in the body (openai-style) beats routing context
        model = self._resolve_adapter(request)
        toks = self.generate(
            prompt_ids,
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
            adapter_id=model,
        )
        return {"token_ids": toks, "num_generated": len(toks)}

    def _resolve_adapter(self, request: Dict[str, Any]) -> Optional[str]:
        """'model' in a request body -> adapter id: the base model's own
        name (model_id) or "" routes to the base engine; anything else
        is a LoRA adapter id (reference ray.llm routing semantics).
        None = no field, fall back to the serve routing context."""
        model = request.get("model")
        if model is not None and model in ("", self.config.model_id):
            return ""
        return model

    def engine_stats(self) -> Dict[str, Any]:
        return {
            "active": self.engine.num_active(),
            "free_slots": sum(
                len(s.free_slots) for s in self.engine.shards
            ),
            "max_batch": self.engine.max_batch,
            "shards": len(self.engine.shards),
        }


def build_llm_app(llm_config: LLMConfig, name: str = "llm", server_cls=None):
    """Bound deployment for `serve.run` (reference: build_openai_app).
    Sizes actor resources from the TP x PP placement bundles."""
    from ray_tpu_torch import serve

    bundles, strategy = llm_config.placement_bundles()
    # single-bundle (pp=1) deployments pin the whole gang's cards on the
    # replica actor; multi-bundle pp is reserved via a placement group by
    # the replica itself when it spins stage actors (future work: true
    # cross-host pp stages). "GPU" is the pinned resource; any other
    # accelerator key is passed through as a custom resource, as the
    # reference passes num_tpus.
    key = llm_config.accelerator_type
    amount = bundles[0].get(key, 0) if key else 0
    if not amount:
        options = None
    elif key == "GPU":
        options = {"num_gpus": amount}
    else:
        options = {"resources": {key: amount}}
    deployment = serve.deployment(
        server_cls or _LLMServerWrapper,
        name=name,
        ray_actor_options=options,
    )
    return deployment.bind(llm_config)


class _LLMServerWrapper(LLMServer):
    """Deployment wrapper (serve.deployment needs a fresh class so user
    code can also subclass LLMServer directly)."""


class OpenAIServer(LLMServer):
    """OpenAI-style completions surface (reference: build_openai_app's
    router deployments). Accepts completion bodies:

        {"model": "<model_id or lora adapter id>",
         "prompt": [token ids] (or "prompt_ids"),
         "max_tokens": N, "temperature": t}

    and answers {"object": "text_completion", "model": ...,
    "choices": [{"token_ids": [...], "index": 0,
    "finish_reason": "length"|"stop"}], "usage": {...}}. Token-id in/out:
    tokenization happens client-side (there is no tokenizer dependency
    in-tree)."""

    def __call__(self, request: Dict[str, Any]):
        import json

        if "prompt" not in request and "prompt_ids" not in request and request.get("body"):
            request = json.loads(request["body"])
        prompt_ids = request.get("prompt_ids") or request.get("prompt")
        if not isinstance(prompt_ids, list):
            raise ValueError(
                "completion request needs 'prompt' (token-id list)"
            )
        adapter = self._resolve_adapter(request)
        max_tokens = int(request.get("max_tokens", 64))
        eos_id = request.get("eos_id")
        toks = self.generate(
            prompt_ids,
            max_tokens=max_tokens,
            temperature=float(request.get("temperature", 0.0)),
            eos_id=eos_id,
            adapter_id=adapter,
        )
        # "stop" ONLY on an eos match; anything else — max_tokens hit or
        # the engine's max_seq context truncation — is "length"
        finish = (
            "stop"
            if eos_id is not None and toks and toks[-1] == eos_id
            else "length"
        )
        return {
            "object": "text_completion",
            "model": adapter or self.config.model_id,
            "choices": [
                {"index": 0, "token_ids": toks, "finish_reason": finish}
            ],
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": len(toks),
                "total_tokens": len(prompt_ids) + len(toks),
            },
        }


def build_openai_app(llm_config: LLMConfig, name: str = "v1-completions"):
    """Bound OpenAI-compatible completions app (reference:
    ray.llm build_openai_app); serve with
    ``serve.run(app, route_prefix="/v1/completions")``."""
    return build_llm_app(llm_config, name=name, server_cls=OpenAIServer)
