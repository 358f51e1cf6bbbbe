"""Continuous-batching inference engine (real execution) on PyTorch.

Slot-based: up to `max_slots` concurrent requests; each step admits the
highest-priority waiting request (priority = HermesScheduler rank when
attached, else FCFS) and decodes every active slot by one token.  Warmable
contents are real: prefix KV caches (computed prefills, stored in the
PrefixCache arena) and LoRA adapters (merged-weight pool).  A cold prefix
costs the full prefix prefill on the critical path; a warm one costs a cache
copy — exactly the Fig. 2 trade the paper's prewarming removes.

The port of the JAX package's ``serving/engine.py``, with the same
admission, prefix, LoRA and step behaviour.  The model writes each decoded
position into a slot's caches in place, so a slot's caches are cloned from
its prefix entry on admission (the entry stays as it was for later hits).
Caches are a dict by kind (``models/transformer.py``): the attention caches
``k``/``v`` laid out for the decode-attention kernel, ``(L, B, K, S, hd)``,
and the Mamba layers' ``ssm`` and ``conv_{x,b,c}``, which do not grow with
the sequence.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.model import Model, Params
from repro_torch.models.transformer import ATTN_CACHES, Caches
from repro_torch.serving.kvcache import PagedAllocator, PrefixCache
from repro_torch.serving.lora import LoraPool


def check_token_only(cfg) -> None:
    """The engine feeds tokens only, as the JAX package's: a model whose
    prefill needs frames or patch embeddings (the encdec and vlm families)
    raises ``ValueError``."""
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(
            f"{cfg.name}: the inference engine feeds tokens only, and the "
            f"{cfg.family} family's prefill needs "
            f"{'frames' if cfg.family == 'encdec' else 'patch embeddings'}; "
            "drive it through Model.prefill / Model.decode")


@dataclass
class Request:
    req_id: str
    prompt: List[int]
    max_new_tokens: int = 16
    app_id: str = ""
    lora_id: str = ""
    prefix_id: str = ""
    eos_id: int = -1
    submitted: float = 0.0
    # results
    output: List[int] = field(default_factory=list)
    ttft: Optional[float] = None
    finished: Optional[float] = None
    prefix_hit: Optional[bool] = None


@dataclass
class _Slot:
    req: Request
    caches: Caches
    pos: int
    next_token: torch.Tensor


class InferenceEngine:
    def __init__(self, model: Model, params: Optional[Params] = None, *,
                 max_slots: int = 4, max_seq: int = 256,
                 kv_blocks: int = 512, block_size: int = 16,
                 lora_capacity: int = 4,
                 prefix_prompts: Optional[Dict[str, List[int]]] = None,
                 on_finish: Optional[Callable[[Request, float],
                                              None]] = None):
        check_token_only(model.cfg)
        self.model = model
        self.device = model.device
        # completion observer: called as ``on_finish(request, service_s)``
        # with the request's measured decode wall seconds.  Hosts that hold
        # a HermesScheduler forward this to ``observe_unit_completion`` so
        # real-engine completions feed the posterior demand statistics the
        # same way simulator completions do.
        self.on_finish = on_finish
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.lora = LoraPool(model.params() if params is None else params,
                             capacity=lora_capacity)
        self.alloc = PagedAllocator(kv_blocks, block_size)
        self.prefix_prompts = prefix_prompts or {}
        self.prefix = PrefixCache(self.alloc, self._compute_prefix)
        self.queue: List[Request] = []
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.done: List[Request] = []
        self.steps = 0

    # ------------------------------------------------------------- helpers
    def _tokens(self, toks: List[int]) -> torch.Tensor:
        return torch.tensor([toks], dtype=torch.long, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _compute_prefix(self, prefix_id: str) -> Tuple[Caches, int]:
        toks = self.prefix_prompts[prefix_id]
        caches, _ = self.model.prefill(self._tokens(toks), self.lora.base)
        caches = self._pad_caches(caches, len(toks))
        self._sync()
        return caches, len(toks)

    def _pad_caches(self, caches: Caches, cur_len: int) -> Caches:
        """Zero-pad the sequence dim of the k/v caches to ``max_seq`` (the
        JAX engine pads by name too: the Mamba caches have no sequence
        dim)."""
        pad = self.max_seq - cur_len
        if pad <= 0:
            return caches
        return {n: F.pad(t, (0, 0, 0, pad)) if n in ATTN_CACHES else t
                for n, t in caches.items()}

    # ----------------------------------------------------------- interface
    def prewarm_prefix(self, prefix_id: str) -> None:
        self.prefix.load(prefix_id, speculative=True)

    def prewarm_lora(self, lora_id: str) -> None:
        self.lora.load(lora_id, speculative=True)

    def apply_prewarm_plan(self, plan, now: Optional[float] = None) -> int:
        """Execute the LLM-side signals of a scheduler PrewarmPlan (the
        batched per-tick plan from ``HermesScheduler.take_prewarm_plan``):
        ``kv:<prefix>`` loads the prefix KV into the arena, ``lora:<id>``
        merges the adapter into the pool.  Non-LLM classes (docker/dnn) have
        no backend here and are skipped.

        ``now`` enforces the §3.4 trigger timing: only signals with
        ``fire_at <= now`` are executed — re-apply the plan on later engine
        steps to pick up the rest (firing early would occupy arena/pool
        capacity exactly as the trigger quantile exists to avoid).  ``None``
        applies everything (caller owns the timing).  Returns the number of
        signals acted on."""
        if plan is None:
            return 0
        acted = 0
        for key, fire_at in zip(plan.resource_keys, plan.fire_at):
            if now is not None and fire_at > now:
                continue
            kind, _, name = key.partition(":")
            if kind == "kv" and name in self.prefix_prompts:
                self.prewarm_prefix(name)
                acted += 1
            elif kind == "lora" and name in self.lora.adapters:
                self.prewarm_lora(name)
                acted += 1
        return acted

    def submit(self, req: Request) -> None:
        req.submitted = req.submitted or time.monotonic()
        self.queue.append(req)

    def _admit(self, req: Request, now: float) -> bool:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        params = self.lora.get(req.lora_id)
        prefix_len = 0
        caches = None
        if req.prefix_id:
            entry = self.prefix.lookup(req.prefix_id)
            req.prefix_hit = entry is not None
            if entry is None:  # cold: compute the prefix on the critical path
                self.prefix.load(req.prefix_id)
                entry = self.prefix.lookup(req.prefix_id)
            prefix_len = entry.length
            # decode writes in place: the entry must stay as it is
            caches = {n: t.clone() for n, t in entry.caches.items()}
        total = prefix_len + len(req.prompt) + req.max_new_tokens
        if total > self.max_seq or not self.alloc.can_allocate(total):
            return False
        self.alloc.allocate(f"req:{req.req_id}", total)

        if caches is None:
            c, logits = self.model.prefill(self._tokens(req.prompt), params)
            caches = self._pad_caches(c, len(req.prompt))
            pos = len(req.prompt)
        else:
            # continue from the warm prefix: feed prompt tokens via decode
            pos = prefix_len
            for t in req.prompt:
                caches, logits = self.model.decode(caches, self._tokens([t]),
                                                   pos, params)
                pos += 1
        nxt = torch.argmax(logits[0, -1])
        self._sync()          # the first token exists: time to first token
        req.ttft = time.monotonic() - req.submitted
        self.slots[free[0]] = _Slot(req, caches, pos, nxt)
        return True

    def _finish(self, i: int, now: float) -> None:
        slot = self.slots[i]
        slot.req.finished = now
        self.alloc.release(f"req:{slot.req.req_id}")
        self.done.append(slot.req)
        self.slots[i] = None
        if self.on_finish is not None:
            # decode wall time: completion minus admission (submit + queue
            # wait + prefill are the TTFT leg)
            svc = now - slot.req.submitted - (slot.req.ttft or 0.0)
            self.on_finish(slot.req, max(svc, 0.0))

    def step(self, rank_fn: Optional[Callable[[Request], float]] = None) -> bool:
        """One engine iteration; returns False when fully idle."""
        now = time.monotonic()
        self.steps += 1
        # admission (highest priority first)
        if self.queue:
            self.queue.sort(key=(lambda r: (rank_fn(r), r.submitted)) if rank_fn
                            else (lambda r: r.submitted))
            while self.queue and any(s is None for s in self.slots):
                if not self._admit(self.queue[0], now):
                    break
                self.queue.pop(0)
        # decode every active slot one token
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            req = slot.req
            tok = int(slot.next_token)
            req.output.append(tok)
            if (len(req.output) >= req.max_new_tokens or tok == req.eos_id
                    or slot.pos + 1 >= self.max_seq):
                self._finish(i, time.monotonic())
                continue
            params = self.lora.get(req.lora_id)
            slot.caches, logits = self.model.decode(
                slot.caches, self._tokens([tok]), slot.pos, params)
            slot.pos += 1
            slot.next_token = torch.argmax(logits[0, -1])
        return bool(self.queue or any(s is not None for s in self.slots))

    def run(self, rank_fn=None, max_steps: int = 100_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.step(rank_fn):
                break
        return self.done
