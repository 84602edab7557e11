"""Continuous-batching scheduler over the paged KV cache.

Port of ``deepspeed_tpu/serving/engine.py:43,98,108``. The batch is a
set of SLOTS that requests flow through independently: a request is
admitted into any free slot the moment enough pool pages are free for
``prompt + max_new_tokens``; its prompt prefills into its own pages;
every scheduler step runs one decode tick over all slots (idle slots
masked by pos < 0); a slot that hits EOS or its budget frees its pages
at once and the next queued request takes it.

Not ported yet (ROADMAP.md queue 2, item 6): the drafter, prefix
cache, roles, elastic controller, watchdog, flight recorder and fault
points.
"""

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.serving.adapters import sample_token
from deepspeed_tpu_torch.serving.paged_cache import (PagedKVCache,
                                                     padded_prefill_inputs)
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_time`` is seconds relative to
    the serve() clock (0 = already queued)."""
    rid: Any
    prompt: Any                       # [S] int array-like
    max_new_tokens: int = 16
    eos_token_id: Optional[int] = None
    temperature: float = 0.0
    arrival_time: float = 0.0
    # per-request sampling identity (temperature > 0 only), stamped once
    # at submit: every sampled token's generator is seeded from
    # (sample_key, global token index)
    sample_key: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None

    def tokens(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = -1                     # rows already in cache; -1 = idle
    last_tok: int = 0                 # token to feed on the next tick

    @property
    def active(self) -> bool:
        return self.request is not None


class ContinuousBatcher:
    """Host-side slot scheduler around one adapter.

    ``serve(requests)`` runs to completion; or ``submit()`` then
    ``step()`` until everything returns."""

    # multi-step dispatch caps: a tick of K steps amortizes the host loop
    # over K tokens. K = min remaining budget is lossless; EOS-capable
    # requests cap K low so an early stop wastes at most
    # max_eos_tick_steps - 1 steps (their appends stay in the slot's pages)
    max_tick_steps = 32
    max_eos_tick_steps = 4

    def __init__(self, adapter, registry: Optional[MetricsRegistry] = None):
        self.adapter = adapter
        self.spec = adapter.spec
        self.cache: PagedKVCache = adapter.make_cache()
        self.slots = [_Slot() for _ in range(self.spec.slots)]
        self.queue: deque = deque()
        self._host_rng = np.random.RandomState(0)
        self.last_logits = None       # [slots, V] of the latest tick
        self.stats = {"ticks": 0, "tick_steps": 0, "decode_tokens": 0,
                      "prefills": 0, "prefill_tokens": 0}
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._t_first_decode = None

    # ----------------------------------------------------------- metrics

    def _note_pool(self) -> None:
        alloc = self.cache.num_blocks - 1
        used = alloc - self.cache.free_pages
        occ = used / max(alloc, 1)
        m = self.metrics
        m.gauge("serving/page_pool_used_pages").set(used)
        m.gauge("serving/page_pool_occupancy").set(occ)
        m.gauge("serving/page_pool_occupancy_hwm").set_max(occ)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Queue depth, admission wait, time-to-first-token, tick
        latency, decode tokens/sec, slot utilization and page-pool
        occupancy (+ high-water mark), plus the stats counters."""
        snap = self.metrics.snapshot()
        hists, gauges = snap["histograms"], snap["gauges"]
        lifetime = (time.monotonic() - self._t_first_decode) \
            if self._t_first_decode is not None else 0.0
        alloc = self.cache.num_blocks - 1
        return {
            "queue_depth": len(self.queue),
            "active_slots": sum(s.active for s in self.slots),
            "slots": len(self.slots),
            "page_pool": {
                "allocatable_pages": alloc,
                "used_pages": alloc - self.cache.free_pages,
                "occupancy": gauges.get("serving/page_pool_occupancy", 0.0),
                "occupancy_hwm": gauges.get(
                    "serving/page_pool_occupancy_hwm", 0.0),
            },
            "admission_wait_s": hists.get("serving/admission_wait_s",
                                          {"count": 0}),
            "ttft_s": hists.get("serving/ttft_s", {"count": 0}),
            "tick_latency_s": hists.get("serving/tick_latency_s",
                                        {"count": 0}),
            "decode_latency_per_token_s": hists.get(
                "serving/decode_latency_per_token_s", {"count": 0}),
            "slot_utilization": hists.get("serving/slot_utilization",
                                          {"count": 0}),
            "decode_tokens_per_sec": (self.stats["decode_tokens"] / lifetime)
            if lifetime > 0 else 0.0,
            **self.stats,
        }

    # ------------------------------------------------------------- queue

    def submit(self, request: Request) -> None:
        S = int(np.asarray(request.prompt).shape[0])
        if S < 1:
            raise ValueError("empty prompt")
        # prefill samples the first token, so a zero budget would still
        # emit one — reject instead of over-serving
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{request.max_new_tokens}")
        total = S + request.max_new_tokens
        budget = self.adapter.max_prompt_len()
        if total > budget:
            raise ValueError(
                f"prompt {S} + max_new_tokens {request.max_new_tokens} "
                f"exceeds the model's position budget {budget}")
        cap = self.spec.max_tokens_per_slot()
        if total > cap:
            raise ValueError(
                f"prompt {S} + max_new_tokens {request.max_new_tokens} "
                f"exceeds the per-slot page capacity {cap} "
                f"(max_pages_per_slot {self.spec.max_pages_per_slot} x "
                f"page_size {self.spec.page_size})")
        if self.cache.pages_needed(total) > self.cache.num_blocks - 1:
            raise ValueError(
                f"request needs {self.cache.pages_needed(total)} pages but "
                f"the whole pool has {self.cache.num_blocks - 1} allocatable "
                f"blocks (serving.num_blocks)")
        max_prompt_pages = budget // self.spec.page_size
        if self.cache.pages_needed(S) > max_prompt_pages:
            raise ValueError(
                f"prompt {S} needs {self.cache.pages_needed(S)} pages but "
                f"only {max_prompt_pages} whole pages of "
                f"{self.spec.page_size} fit the model's {budget}-position "
                f"budget")
        if request.temperature and request.temperature > 0 \
                and request.sample_key is None:
            request.sample_key = int(self._host_rng.randint(0, 2 ** 31 - 1))
        request._t_submit = time.monotonic()
        self.queue.append(request)
        self.metrics.gauge("serving/queue_depth").set(len(self.queue))

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(s.active for s in self.slots)

    # --------------------------------------------------------- admission

    def _pick_token(self, logits, req: Request) -> int:
        if req.temperature and req.temperature > 0:
            return sample_token(logits, req.sample_key or 0,
                                len(req.generated), req.temperature)
        return int(np.argmax(logits))

    def _admit(self, now: Optional[float]) -> List[Request]:
        finished = []
        free = [i for i, s in enumerate(self.slots) if not s.active]
        P = self.spec.page_size
        while free and self.queue:
            req = self.queue[0]
            if now is not None and req.arrival_time > now:
                break                 # FIFO: don't skip ahead of arrivals
            prompt_np = np.asarray(req.prompt, np.int32)
            S = int(prompt_np.shape[0])
            slot_id = free[0]
            pages = self.cache.admit(slot_id, S + req.max_new_tokens)
            if pages is None:
                break                 # pool exhausted; retry next step
            self.queue.popleft()
            free.pop(0)
            t_admit = time.monotonic()
            t_ref = getattr(req, "_t_arrived", None)
            if t_ref is None:
                t_ref = getattr(req, "_t_submit", t_admit)
            self.metrics.histogram("serving/admission_wait_s").observe(
                max(t_admit - t_ref, 0.0))
            ids, page_vec = padded_prefill_inputs(
                prompt_np, pages, P, self.adapter.max_prompt_len() // P)
            pool, logits = self.adapter.prefill(self.cache.pool, ids, S,
                                                page_vec)
            self.cache.pool = pool
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += S
            # the logits readback is first-token delivery
            tok = self._pick_token(logits.cpu().numpy(), req)
            req.generated.append(tok)
            self.metrics.histogram("serving/ttft_s").observe(
                max(time.monotonic() - t_ref, 0.0))
            if self._t_first_decode is None:
                self._t_first_decode = time.monotonic()
            slot = self.slots[slot_id]
            slot.request, slot.pos, slot.last_tok = req, S, tok
            done = self._maybe_finish(slot_id)
            if done is not None:      # max_new_tokens == 1 / instant EOS
                finished.append(done)
                free.insert(0, slot_id)
        self.metrics.gauge("serving/queue_depth").set(len(self.queue))
        self._note_pool()
        return finished

    # -------------------------------------------------------------- tick

    def _maybe_finish(self, slot_id: int) -> Optional[Request]:
        slot = self.slots[slot_id]
        req = slot.request
        if req is None:
            return None
        if req.eos_token_id is not None \
                and req.generated[-1] == req.eos_token_id:
            req.finish_reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return None
        self.cache.release(slot_id)
        slot.request, slot.pos, slot.last_tok = None, -1, 0
        return req

    def _pick_tick_steps(self) -> int:
        if self.queue and any(not s.active for s in self.slots):
            return 1                  # admission pending — stay responsive
        active = [s.request for s in self.slots if s.active]
        rem = min(r.max_new_tokens - len(r.generated) for r in active)
        cap = self.max_eos_tick_steps if any(
            r.eos_token_id is not None for r in active) \
            else self.max_tick_steps
        k = 1
        while k * 2 <= min(rem, cap):  # pow2 steps, as the JAX engine
            k *= 2
        return k

    def _tick(self) -> List[Request]:
        steps = self._pick_tick_steps()
        n_active = sum(s.active for s in self.slots)
        toks = np.array([s.last_tok for s in self.slots], np.int64)
        pos = np.array([s.pos if s.active else -1 for s in self.slots],
                       np.int32)
        temps = np.array([s.request.temperature if s.active else 0.0
                          for s in self.slots], np.float32)
        seeds = np.array([(s.request.sample_key or 0) if s.active else 0
                          for s in self.slots], np.int64)
        idxs = np.array([len(s.request.generated) if s.active else 0
                         for s in self.slots], np.int64)
        t0 = time.monotonic()
        pool, toks_seq, logits = self.adapter.tick(
            self.cache.pool, toks, pos, self.cache.page_table, seeds, idxs,
            temps, steps=steps)
        self.cache.pool = pool
        self.last_logits = logits
        toks_seq = toks_seq.cpu().numpy()   # the scheduler's one readback
        tick_s = time.monotonic() - t0      # real: the readback fenced it
        m = self.metrics
        m.histogram("serving/tick_latency_s").observe(tick_s)
        m.histogram("serving/decode_latency_per_token_s").observe(
            tick_s / max(steps, 1))
        m.histogram("serving/slot_utilization").observe(
            n_active / max(len(self.slots), 1))
        self.stats["ticks"] += 1
        self.stats["tick_steps"] += steps
        finished = []
        tokens_before = self.stats["decode_tokens"]
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            for t in range(steps):
                self.stats["decode_tokens"] += 1
                tok = int(toks_seq[t, i])
                slot.request.generated.append(tok)
                slot.pos += 1
                slot.last_tok = tok
                done = self._maybe_finish(i)
                if done is not None:
                    # steps past an EOS were speculative; their appends
                    # landed in pages this slot owned until right now
                    finished.append(done)
                    break
        m.counter("serving/decode_tokens").inc(
            self.stats["decode_tokens"] - tokens_before)
        self._note_pool()
        return finished

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One scheduler iteration: admit whatever fits, then one decode
        tick over the active slots. Returns the requests finished this
        step (including any that finished at prefill)."""
        finished = self._admit(now)
        if any(s.active for s in self.slots):
            finished.extend(self._tick())
        return finished

    def serve(self, requests: Sequence[Request],
              respect_arrival_times: bool = False) -> Dict[Any, Request]:
        """Run the scheduler until every request completes. With
        ``respect_arrival_times`` a request becomes admissible only at
        its ``arrival_time`` on a wall clock started on entry."""
        for r in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(r)
        done: Dict[Any, Request] = {}
        t0 = time.monotonic()
        if respect_arrival_times:
            for r in requests:
                r._t_arrived = t0 + r.arrival_time
        while self.pending:
            now = (time.monotonic() - t0) if respect_arrival_times \
                else None
            if respect_arrival_times and self.queue and not any(
                    s.active for s in self.slots):
                wait = self.queue[0].arrival_time - (time.monotonic() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
                    continue
            for req in self.step(now):
                done[req.rid] = req
        return done
