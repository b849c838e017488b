"""LlamaEngine: generation with continuous batching, PyTorch port of
``ray_tpu/llm/_internal/engine.py``. Every scheduling rule of the
reference holds:

- Slot-based continuous batching: cache SHARDS of ``max_batch`` slots;
  every decode step advances one shard's active slots in one (B, 1)
  forward. When all slots are busy the engine GROWS by another shard, up
  to ``max_slots``.
- CHUNKED prefill: prompts enter the cache ``prefill_chunk`` tokens per
  engine step, one chunk per shard per step, interleaved with decode, so
  a long prompt cannot stall running sequences. The chunk divides
  ``max_seq``.
- KV cache preallocated per shard (L, B, max_seq, KVH, hd) and written in
  place; per-slot lengths mask attention (``models/llama.py``
  ``forward_with_cache``).
- Greedy decoding, or temperature sampling from a ``torch.Generator``
  seeded from ``seed``.

The reference pads prefill chunks to power-of-two buckets only to bound
JIT compilations; eager PyTorch has none, so a chunk is written at its
real length, which gives the same cache rows and logits.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..._private.device import DeviceLike, resolve_device
from ...models import llama


@dataclass
class GenRequest:
    request_id: str
    prompt_ids: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    adapter_id: str = ""  # LoRA adapter ("" = base model)
    # filled during generation
    slot: int = -1
    shard: int = -1
    prefill_pos: int = 0  # prompt tokens already written to cache
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Shard:
    """One (B, max_seq) KV cache block plus its slot bookkeeping."""

    cache: Dict[str, torch.Tensor]
    lengths: np.ndarray
    free_slots: List[int]
    active: Dict[int, GenRequest] = field(default_factory=dict)
    prefilling: "deque[GenRequest]" = field(default_factory=deque)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class LlamaEngine:
    def __init__(
        self,
        config: llama.LlamaConfig,
        params,
        *,
        max_batch: int = 8,
        max_seq: int = 512,
        seed: int = 0,
        prefill_chunk: int = 64,
        max_slots: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        for t in _leaves(params):
            if t.device != self.device:
                raise ValueError(
                    f"parameter on {t.device}, engine on {self.device}")
        self.config = config
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        # chunk must divide max_seq: chunk starts are then always aligned
        # and a chunk can never run past the cache end
        chunk = min(prefill_chunk, max_seq)
        while max_seq % chunk:
            chunk //= 2
        self.prefill_chunk = max(chunk, 1)
        # growth is whole-shard; round the cap to shard granularity so
        # the KV-memory bound it expresses actually holds
        want_slots = max_slots or 4 * max_batch
        self.max_slots = max(max_batch, (want_slots // max_batch) * max_batch)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.shards: List[_Shard] = [self._new_shard()]
        self._lock = threading.Lock()

    def _new_shard(self) -> _Shard:
        return _Shard(
            cache=llama.init_kv_cache(self.config, self.max_batch, self.max_seq,
                                      device=self.device),
            lengths=np.zeros(self.max_batch, dtype=np.int32),
            free_slots=list(range(self.max_batch)),
        )

    # ------------------------------------------------------------------
    def has_capacity(self) -> bool:
        if any(s.free_slots for s in self.shards):
            return True
        return len(self.shards) * self.max_batch < self.max_slots

    def num_active(self) -> int:
        return sum(len(s.active) + len(s.prefilling) for s in self.shards)

    def in_flight_requests(self) -> List[GenRequest]:
        out: List[GenRequest] = []
        for s in self.shards:
            out.extend(s.active.values())
            out.extend(s.prefilling)
        return out

    def abort_all(self) -> List[GenRequest]:
        """Drop every in-flight request (engine fault path); returns them
        so the caller can fail their waiters."""
        with self._lock:
            dropped = self.in_flight_requests()
            for s in self.shards:
                for slot in list(s.active):
                    self._finish(s, slot)
                while s.prefilling:
                    req = s.prefilling.popleft()
                    req.done = True
                    s.lengths[req.slot] = 0
                    s.free_slots.append(req.slot)
            return dropped

    def add_request(self, req: GenRequest) -> bool:
        """Admit into a free slot. No model compute happens here: the
        prompt prefills chunk by chunk inside step(), interleaved with
        decode."""
        with self._lock:
            if len(req.prompt_ids) >= self.max_seq:
                raise ValueError(
                    f"prompt length {len(req.prompt_ids)} >= max_seq {self.max_seq}"
                )
            si = next((i for i, s in enumerate(self.shards) if s.free_slots), None)
            if si is None:
                if len(self.shards) * self.max_batch >= self.max_slots:
                    return False
                self.shards.append(self._new_shard())  # slot growth
                si = len(self.shards) - 1
            shard = self.shards[si]
            req.slot = shard.free_slots.pop()
            req.shard = si
            req.prefill_pos = 0
            shard.prefilling.append(req)
            return True

    def _finish(self, shard: _Shard, slot: int):
        req = shard.active.pop(slot)
        req.done = True
        shard.lengths[slot] = 0
        shard.free_slots.append(slot)

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
        """logits (B, V) f32, temps (B,) -> tokens (B,): argmax where the
        temperature is 0, else a draw from softmax(logits / t)."""
        greedy = logits.argmax(dim=-1)
        if not bool((temps > 0).any()):
            return greedy
        probs = torch.softmax(logits / temps.clamp(min=1e-4)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(temps > 0, sampled, greedy)

    def _pump_prefill(self, shard: _Shard, out: List[Tuple[GenRequest, int]]):
        """Write ONE chunk of the oldest pending prompt into the cache; on
        prompt completion, sample the first token and activate the slot
        for decoding."""
        if not shard.prefilling:
            return
        req = shard.prefilling[0]
        n = len(req.prompt_ids)
        pos = req.prefill_pos
        chunk = min(self.prefill_chunk, n - pos)
        tokens = torch.tensor([req.prompt_ids[pos:pos + chunk]], dtype=torch.long,
                              device=self.device)
        s = req.slot
        slot_cache = {"k": shard.cache["k"][:, s:s + 1], "v": shard.cache["v"][:, s:s + 1]}
        logits, _ = llama.forward_with_cache(self.params, tokens, slot_cache, [pos],
                                             self.config)
        req.prefill_pos = pos + chunk
        if req.prefill_pos < n:
            return
        # prompt complete: first generated token from the last logits
        shard.prefilling.popleft()
        temp = torch.tensor([req.temperature], dtype=torch.float32, device=self.device)
        tok = int(self._sample(logits[:, chunk - 1], temp)[0])
        req.generated.append(tok)
        shard.lengths[req.slot] = n
        shard.active[req.slot] = req
        out.append((req, tok))
        if (req.eos_id is not None and tok == req.eos_id) or (
            len(req.generated) >= req.max_tokens
        ):
            self._finish(shard, req.slot)

    def _decode(self, shard: _Shard) -> np.ndarray:
        last = np.zeros(self.max_batch, np.int64)
        temps = np.zeros(self.max_batch, np.float32)
        # inactive lanes (free or mid-prefill) still ride the batched
        # decode; point their cache write at the scratch row (max_seq-1,
        # never attended: sequences finish before reaching it) so they
        # cannot corrupt a half-prefilled prompt's rows
        lens = np.full(self.max_batch, self.max_seq - 1, np.int64)
        for slot, req in shard.active.items():
            last[slot] = req.generated[-1]
            temps[slot] = req.temperature
            lens[slot] = shard.lengths[slot]
        logits, _ = llama.forward_with_cache(
            self.params, torch.from_numpy(last).to(self.device)[:, None],
            shard.cache, lens, self.config)
        toks = self._sample(logits[:, 0], torch.from_numpy(temps).to(self.device))
        return toks.cpu().numpy()

    def step(self) -> List[Tuple[GenRequest, int]]:
        """One engine step: per shard, one prefill chunk (if a prompt is
        pending) then one decode for every active slot. Returns (request,
        new_token) pairs emitted this step; a request's FIRST token
        (sampled off its prefill) arrives here too."""
        with self._lock, torch.no_grad():
            out: List[Tuple[GenRequest, int]] = []
            for shard in self.shards:
                self._pump_prefill(shard, out)
                if not shard.active:
                    continue
                toks = self._decode(shard)
                for slot in list(shard.active.keys()):
                    req = shard.active[slot]
                    # the decode consumed the previous token: account it
                    shard.lengths[slot] += 1
                    tok = int(toks[slot])
                    req.generated.append(tok)
                    out.append((req, tok))
                    total_len = shard.lengths[slot] + 1
                    if (
                        (req.eos_id is not None and tok == req.eos_id)
                        or len(req.generated) >= req.max_tokens
                        or total_len >= self.max_seq - 1
                    ):
                        self._finish(shard, slot)
            return out

    # ------------------------------------------------------------------
    def generate(self, prompt_ids: List[int], *, max_tokens: int = 64,
                 temperature: float = 0.0, eos_id: Optional[int] = None
                 ) -> List[int]:
        """Synchronous single-prompt convenience (batch path: step())."""
        req = GenRequest(
            request_id="sync", prompt_ids=list(prompt_ids),
            max_tokens=max_tokens, temperature=temperature, eos_id=eos_id,
        )
        if not self.add_request(req):
            raise RuntimeError("engine full")
        while not req.done:
            self.step()
        return req.generated
