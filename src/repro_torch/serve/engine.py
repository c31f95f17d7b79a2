"""Serving engines (PyTorch port of ``repro/serve/engine.py``): the
wave-batched dense baseline and paged continuous batching.

``ServeEngine`` is the dense baseline: one prefill of a wave of requests,
then ``max_new_tokens - 1`` decode steps over the wave's dense cache.
Every request in a wave decodes to ``max_new_tokens`` even if it hit EOS
at step 2; the wasted steps are what ``RequestResult.decode_steps`` makes
visible and what ``PagedServeEngine`` removes.  The reference runs its
decode steps as one jitted ``lax.scan``; here they are an eager loop.

``PagedServeEngine`` mirrors the reference step for step:

  * FIFO, head-of-line admission gated by ``BlockAllocator.reserve``;
  * one prefill chunk per admitting slot per loop;
  * one decode step over the FIXED slot array with an active mask;
  * pages taken on demand and released the moment a request finishes,
    so a finished slot is refilled on the very next step.

The reference jits one decode step and donates the pool; here each step
runs eagerly and writes the per-layer pool in place.  Slot state is
uploaded to the device only when the host's copy changed, as in the
reference.

Both engines take an optional ``metrics=`` (``telemetry/metrics.py``'s
``MetricsLogger``): one ``serve_summary`` row per ``serve_queue`` call,
and from the paged engine one ``serve_step`` row per decode step, with
the reference's keys and values (wall times aside).

MoE archs: expert capacity applies per routing group, so a MoE that
drops tokens routes chunked prefill groups differently from a
full-prompt prefill.  With a dropless capacity factor
(``cf >= n_experts / top_k``) chunking changes nothing and paged and
dense greedy outputs agree (models/moe.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.transformer import ModelBundle
from repro_torch.serve.kvcache import BlockAllocator, pages_for, pool_pages


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    eos_id: int = -1                # -1 => never stop early
    seed: int = 0


@dataclasses.dataclass
class RequestResult:
    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray              # generated tokens (trimmed at EOS)
    steps: int                      # == len(tokens) (post-trim)
    # decode iterations actually spent on this request (prefill's free
    # first token excluded).  For the dense wave engine this is always
    # max_new_tokens - 1: EOS does not stop the wave
    decode_steps: int = 0


def _bucket_len(n: int, floor: int = 8) -> int:
    """Next power of two >= n (>= floor): the wave's prompt pad target,
    so mixed prompt lengths give a log-bounded set of prefill shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


def _greedy_or_draw(logits: torch.Tensor, temperature: float,
                    rng: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax (first index on ties, like jnp.argmax) or a
    temperature draw from ``rng``.  The draws are torch's, not JAX's:
    only greedy outputs match the reference's."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[..., 0].to(
        torch.int32)


def _seeded(gen: "GenerationConfig", device) -> Optional[torch.Generator]:
    if gen.temperature <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(gen.seed)


def _queue_summary(engine: str, results: List[RequestResult],
                   wall_s: float, *, refill_events: int = 0,
                   peak_pages_in_use: int = 0, pool_pages: int = 0,
                   mean_occupancy: float = 0.0) -> Dict[str, Any]:
    """One steady-state summary dict per serve_queue call.  The wasted
    ratio is the fraction of decode-slot work that produced no kept token
    (each request's first token is the prefill's free sample)."""
    tokens = sum(r.steps for r in results)
    decode_steps = sum(r.decode_steps for r in results)
    return {
        "engine": engine, "requests": len(results), "tokens": tokens,
        "decode_steps": decode_steps, "wall_s": round(wall_s, 4),
        "tokens_per_s": round(tokens / wall_s, 1) if wall_s > 0 else 0.0,
        "wasted_ratio": round(
            1.0 - (tokens - len(results)) / max(1, decode_steps), 3),
        "refill_events": refill_events,
        "peak_pages_in_use": peak_pages_in_use,
        "pool_pages": pool_pages,
        "mean_occupancy": round(mean_occupancy, 3),
    }


class ServeEngine:
    """Wave-batched serving over a dense cache.

    ``prefill_traces`` and ``decode_traces`` count calls: the prefills run
    and the decode loops entered (the reference counts its jit traces,
    which the eager port does not have; the paged engine's
    ``decode_calls`` counts the same way).
    """

    def __init__(self, bundle: ModelBundle, params, *, max_len: int = 1024,
                 gen: GenerationConfig = GenerationConfig(),
                 metrics: Optional[Any] = None):
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.max_len = max_len
        self.gen = gen
        self.metrics = metrics
        self.last_summary: Optional[Dict[str, Any]] = None
        self.prefill_traces = 0
        self.decode_traces = 0
        self.finish_times: Dict[int, float] = {}

    def steady_state_summary(self) -> Optional[Dict[str, Any]]:
        """Summary of the last ``serve_queue`` call (None before one)."""
        return self.last_summary

    def _prefill(self, params, batch):
        self.prefill_traces += 1
        return self.bundle.prefill(params, dict(batch, max_len=self.max_len))

    def _decode_loop(self, params, tok, cache, rng, steps: int):
        """``steps`` decode steps from ``tok`` -> tokens [B, steps]."""
        self.decode_traces += 1
        toks = []
        for _ in range(steps):
            logits, cache = self.bundle.decode_step(params, tok, cache)
            tok = _greedy_or_draw(logits, self.gen.temperature, rng)
            toks.append(tok)
        return torch.stack(toks, 1), cache

    @torch.no_grad()
    def generate(self, prompts, extras: Optional[Dict[str, Any]] = None
                 ) -> np.ndarray:
        """prompts [B, S] int -> generated tokens [B, max_new_tokens]."""
        prompts = torch.as_tensor(prompts, device=self.device)
        batch = {"tokens": prompts}
        if extras:
            batch.update(extras)
        logits, cache = self._prefill(self.params, batch)
        rng = _seeded(self.gen, self.device)
        first = _greedy_or_draw(logits, self.gen.temperature, rng)
        out = [first[:, None]]
        if self.gen.max_new_tokens > 1:
            toks, _ = self._decode_loop(self.params, first, cache, rng,
                                        self.gen.max_new_tokens - 1)
            out.append(toks)
        return torch.cat(out, 1).cpu().numpy()

    def serve_queue(self, requests: Sequence[np.ndarray], *,
                    slots: int = 4,
                    max_new: Optional[Sequence[int]] = None
                    ) -> List[RequestResult]:
        """Requests in waves of ``slots``; each wave left-pads (token 0, no
        mask) to the power-of-two bucket of its longest prompt.  A
        request's ``max_new`` budget trims its tokens, but the wave still
        decodes ``gen.max_new_tokens``: the wasted steps ``decode_steps``
        shows.  Per-request completion times (seconds since the call
        started) land in ``self.finish_times``."""
        results: List[RequestResult] = []
        queue = list(enumerate(requests))
        eos = self.gen.eos_id
        self.finish_times = {}
        t0 = time.time()
        while queue:
            wave, queue = queue[:slots], queue[slots:]
            longest = max(len(p) for _, p in wave)
            if longest > self.max_len:
                raise ValueError(f"prompt length {longest} exceeds "
                                 f"max_len {self.max_len}")
            L = min(_bucket_len(longest), self.max_len)
            prompts = np.zeros((len(wave), L), np.int32)
            for r, (_, p) in enumerate(wave):
                prompts[r, L - len(p):] = p
            toks = self.generate(prompts)
            done = time.time() - t0
            for r, (rid, _) in enumerate(wave):
                t = toks[r]
                if max_new is not None:
                    t = t[:max_new[rid]]
                if eos >= 0 and (t == eos).any():
                    t = t[:int(np.argmax(t == eos)) + 1]
                results.append(RequestResult(
                    rid, prompts[r], t, len(t),
                    decode_steps=self.gen.max_new_tokens - 1))
                self.finish_times[rid] = done
        self.last_summary = _queue_summary("dense", results,
                                           time.time() - t0)
        if self.metrics is not None:
            self.metrics.log_row("serve_summary", **self.last_summary)
            self.metrics.flush()
        return results


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one batch slot."""
    state: str = "free"             # free | prefill | decode
    rid: int = -1
    prompt: Optional[np.ndarray] = None
    plen: int = 0
    target: int = 0                 # token budget for this request
    base: int = 0                   # next prefill chunk start
    pages: List[int] = dataclasses.field(default_factory=list)
    reserved: int = 0               # reservation units not yet taken
    toks: List[int] = dataclasses.field(default_factory=list)
    decode_steps: int = 0
    last_tok: int = 0


class PagedServeEngine:
    """Token-level continuous batching over a paged KV cache.

    The decode step runs over a fixed ``slots``-wide array: per-slot
    cache lengths, an active mask and a block table are the only things
    that change between steps.  A request enters a free slot only when
    the allocator can reserve its worst-case page count, and its pages
    return to the pool the moment it finishes.
    """

    def __init__(self, bundle: ModelBundle, params, *,
                 slots: int = 4, page_size: int = 16,
                 max_len: int = 1024, prefill_chunk: int = 32,
                 budget_bytes: Optional[int] = None,
                 cache_dtype=torch.bfloat16,
                 gen: GenerationConfig = GenerationConfig(),
                 metrics: Optional[Any] = None):
        if bundle.decode_step_paged is None:
            raise ValueError(
                f"arch '{bundle.cfg.name}' (family {bundle.cfg.family}) has "
                f"a constant-size or unsupported decode state; paged "
                f"serving needs a positional KV/latent cache — use "
                f"ServeEngine")
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.slots = slots
        self.page_size = page_size
        self.max_len = max_len
        self.chunk = prefill_chunk
        self.gen = gen
        # tables (and the no-budget pool default) cover the chunk-padded
        # max length: the last prefill chunk writes masked garbage past
        # the true prompt end, and those positions still need real pages
        self.max_pages_per_seq = pages_for(self._padded(max_len), page_size)

        # cache_dtype only sizes the pool; the pool's real dtype is the
        # bundle's (build(cache_dtype=)), as in the reference
        n_pages = pool_pages(bundle.cfg, page_size,
                             budget_bytes=budget_bytes, slots=slots,
                             max_len=self._padded(max_len),
                             cache_dtype=cache_dtype)
        self.alloc = BlockAllocator(n_pages)
        self.pages = bundle.init_paged_cache(n_pages, page_size)
        self._slots = [_Slot() for _ in range(slots)]
        self._tables = np.zeros((slots, self.max_pages_per_seq), np.int32)
        self._lengths = np.zeros((slots,), np.int32)

        self.finish_times: Dict[int, float] = {}
        self._t0 = 0.0
        # serve_step rows per decode step (slot occupancy, pool pressure)
        # and one serve_summary row per serve_queue call
        self.metrics = metrics
        self.last_summary: Optional[Dict[str, Any]] = None
        # decode steps run by the last serve_queue call
        self.decode_calls = 0
        # admissions that landed AFTER some resident finished during the
        # current serve_queue call: token-level slot refills
        self.refill_events = 0
        self._finishes_this_call = 0
        # host slot state changed since the last device upload
        self._dirty = True

    def steady_state_summary(self) -> Optional[Dict[str, Any]]:
        """Summary of the last ``serve_queue`` call (None before one)."""
        return self.last_summary

    # ------------------------------------------------------------ #
    # device steps

    def _decode(self, params, toks, pages, tables, lengths, active, rng):
        """One decode step.  What the next step needs (tokens, advanced
        lengths) stays on the device; the host reads back the tokens."""
        logits, pages = self.bundle.decode_step_paged(
            params, toks, pages, tables, lengths, active)
        nxt = _greedy_or_draw(logits, self.gen.temperature, rng)
        return (torch.where(active, nxt, torch.zeros_like(nxt)), pages,
                lengths + active.to(torch.int32))

    def _prefill_chunk(self, params, toks, pages, table, base: int):
        return self.bundle.prefill_paged_chunk(params, toks, pages, table,
                                               base)

    # ------------------------------------------------------------ #
    # host-side slot machinery

    def _padded(self, plen: int) -> int:
        return -(-plen // self.chunk) * self.chunk

    def _need_pages(self, plen: int, target: int) -> int:
        """Worst-case pages a request can touch: the full generation
        (prompt + its token budget) or the chunk-padded prefill tail,
        whichever reaches further."""
        reach = max(plen + target, self._padded(plen))
        return pages_for(reach, self.page_size)

    def _grow_to(self, i: int, n_tokens: int) -> None:
        """Ensure slot i's table has pages covering positions [0, n_tokens)."""
        s = self._slots[i]
        while len(s.pages) * self.page_size < n_tokens:
            if s.reserved <= 0:
                raise RuntimeError("slot outgrew its admission reservation")
            pg = self.alloc.take()
            s.reserved -= 1
            self._tables[i, len(s.pages)] = pg
            s.pages.append(pg)
            self._dirty = True

    def _admit(self, i: int, rid: int, prompt: np.ndarray,
               target: int) -> bool:
        plen = len(prompt)
        if plen + target > self.max_len:
            raise ValueError(
                f"request {rid}: prompt {plen} + max_new {target} "
                f"exceeds max_len {self.max_len}")
        need = self._need_pages(plen, target)
        if not self.alloc.reserve(need):
            return False
        if self._finishes_this_call > 0:
            self.refill_events += 1
        s = self._slots[i]
        s.state, s.rid, s.plen, s.base = "prefill", rid, plen, 0
        s.target = target
        s.prompt = np.asarray(prompt, np.int32)
        s.pages, s.reserved, s.toks, s.decode_steps = [], need, [], 0
        self._tables[i, :] = 0
        self._lengths[i] = 0
        self._dirty = True
        return True

    def _finish(self, i: int, results: Dict[int, RequestResult]) -> None:
        s = self._slots[i]
        t = np.asarray(s.toks, np.int32)
        results[s.rid] = RequestResult(s.rid, s.prompt, t, len(t),
                                       decode_steps=s.decode_steps)
        self.finish_times[s.rid] = time.time() - self._t0
        self._finishes_this_call += 1
        self.alloc.release(s.pages, reserved_left=s.reserved)
        self._tables[i, :] = 0
        self._lengths[i] = 0
        self._slots[i] = _Slot()
        self._dirty = True

    def _push_token(self, i: int, tok: int,
                    results: Dict[int, RequestResult]) -> None:
        """Record a sampled token; finish the slot on EOS / token budget."""
        s = self._slots[i]
        s.toks.append(tok)
        s.last_tok = tok
        done = (len(s.toks) >= s.target
                or (self.gen.eos_id >= 0 and tok == self.gen.eos_id))
        if done:
            self._finish(i, results)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: later host edits must not reach the device state
        return torch.tensor(a, device=self.device)

    # ------------------------------------------------------------ #

    @torch.no_grad()
    def serve_queue(self, requests: Sequence[np.ndarray], *,
                    max_new: Optional[Sequence[int]] = None
                    ) -> List[RequestResult]:
        """Continuously-batched serving of a request queue.

        Admission is FIFO (head-of-line: a request too large for the
        remaining pool blocks later ones); results come back ordered by
        request id.  ``max_new`` optionally carries per-request token
        budgets (default: ``gen.max_new_tokens``).  Per-request completion
        times land in ``self.finish_times``.
        """
        queue = list(enumerate(requests))
        results: Dict[int, RequestResult] = {}
        rng = _seeded(self.gen, self.device)
        self.finish_times = {}
        self._t0 = time.time()
        self.refill_events = 0
        self._finishes_this_call = 0
        decode_step_idx = 0
        occ_sum = 0.0
        # device-side steady state: uploaded only when host slot state
        # changes (admit / finish / page growth / prefill completion)
        self._dirty = True
        toks_d = tables_d = lengths_d = active_d = None

        while queue or any(s.state != "free" for s in self._slots):
            # 1. admit newcomers into free slots (FIFO, pool-gated)
            for i, s in enumerate(self._slots):
                if not queue:
                    break
                if s.state == "free":
                    rid, prompt = queue[0]
                    target = (max_new[rid] if max_new is not None
                              else self.gen.max_new_tokens)
                    if not self._admit(i, rid, prompt, target):
                        break           # head-of-line: wait for pages
                    queue.pop(0)

            # 2. one prefill chunk per admitting slot (residents keep
            #    decoding between chunks)
            for i, s in enumerate(self._slots):
                if s.state != "prefill":
                    continue
                self._grow_to(i, s.base + self.chunk)
                padded = np.zeros((self.chunk,), np.int32)
                span = s.prompt[s.base:s.base + self.chunk]
                padded[:len(span)] = span
                logits, self.pages = self._prefill_chunk(
                    self.params, self._to_device(padded[None]), self.pages,
                    self._to_device(self._tables[i:i + 1]), s.base)
                s.base += self.chunk
                if s.base >= s.plen:    # prompt fully cached -> sample
                    last = logits[0, s.plen - 1 - (s.base - self.chunk)]
                    tok = int(_greedy_or_draw(last[None], self.gen.temperature,
                                              rng)[0])
                    s.state = "decode"
                    self._lengths[i] = s.plen
                    self._dirty = True
                    self._push_token(i, tok, results)

            # 3. one decode step over every resident (fixed shapes: the
            #    slot array never changes size, only the active mask)
            active = [s.state == "decode" for s in self._slots]
            if any(active):
                for i in range(self.slots):
                    if active[i]:       # page for the token being written
                        self._grow_to(i, int(self._lengths[i]) + 1)
                if self._dirty:         # slot population changed: upload
                    toks_d = self._to_device(
                        np.array([s.last_tok for s in self._slots],
                                 np.int32))
                    tables_d = self._to_device(self._tables)
                    lengths_d = self._to_device(self._lengths)
                    active_d = self._to_device(np.array(active))
                    self._dirty = False
                toks_d, self.pages, lengths_d = self._decode(
                    self.params, toks_d, self.pages, tables_d, lengths_d,
                    active_d, rng)
                nxt = toks_d.cpu().numpy()
                n_active = sum(active)
                for i in range(self.slots):
                    if active[i]:
                        self._lengths[i] += 1
                        self._slots[i].decode_steps += 1
                        self._push_token(i, int(nxt[i]), results)
                occ_sum += n_active / self.slots
                if self.metrics is not None:
                    self.metrics.log_row(
                        "serve_step", step=decode_step_idx,
                        active_slots=n_active,
                        occupancy=round(n_active / self.slots, 3),
                        new_tokens=n_active,
                        pages_in_use=self.alloc.in_use)
                decode_step_idx += 1

        self.decode_calls = decode_step_idx
        out = [results[rid] for rid in sorted(results)]
        self.last_summary = _queue_summary(
            "paged", out, time.time() - self._t0,
            refill_events=self.refill_events,
            peak_pages_in_use=self.alloc.peak_in_use,
            pool_pages=self.alloc.n_pages - 1,
            mean_occupancy=occ_sum / max(1, decode_step_idx))
        if self.metrics is not None:
            self.metrics.log_row("serve_summary", **self.last_summary)
            self.metrics.flush()
        return out
