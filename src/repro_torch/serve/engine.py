"""Continuous-batching generation engine over the paged COW KV cache.

The port of ``repro.serve.engine`` (same scheduling, same counters, same
rollouts); what differs is PyTorch idiom.  The pools live on the engine's
device and are updated in place; sampling draws from a
``torch.Generator`` (greedy streams are identical to the reference's,
sampled ones match only in distribution); a decode step uploads its
token / position / active vectors in one copy and brings the sampled
tokens and log-probs back in one copy; and the engine's entry points run
under ``torch.no_grad()``.  ``device=None`` means the GPU.

The static ``RolloutEngine`` admits one right-padded batch, decodes every
row until the *slowest* row finishes, and only then returns — finished
rows burn decode slots, and the slot count is frozen at batch boundaries.
This engine runs the standard serving loop instead:

  per step:  admit-from-queue  →  one batched decode token for every
             active sequence  →  prefill chunks with the leftover token
             budget  →  evict finished sequences (EOS / per-request cap),
             freeing their pages and slots for the queue.

**Prefix sharing.** Our RL loop generates GRPO groups — ``G`` completions
of the *same* prompt — so prefilling the prompt G times and storing G
copies of its KV pages wastes both FLOPs and the pool capacity that
bounds the decode batch.  ``submit_group(task, G)`` enqueues the group;
admission coalesces queued requests with identical prompts (hash of the
token ids — this also dedupes identical prompts submitted separately)
into one *leader* that prefills plus ``FORK`` siblings that wait.  When
the leader's prefill completes, each sibling forks the leader's pages
(``PagedKVCache.fork_slot``: block-table aliasing + refcounts, no data
movement), samples its own first token from the shared prompt logits, and
decodes as an ordinary continuous-batching slot.  Writes into a shared
page hit the copy-on-write barrier (``writable``), so siblings diverge
page-locally: fork → shared → diverge → copy.  Preempting a forked slot
just decrements refcounts and requeues it as a solo request (full
recompute — work lost, correctness kept); preempting a leader drags its
pending forks back to the queue with it.  Per-sibling greedy decode is
token-identical to a B=1 static run of the same prompt.

**Cross-request radix cache (``serve.radix``).** Fork sharing needs the
leader to still be mid-prefill; the radix tree (``serve.radix.RadixCache``)
has no such window.  Finished sequences insert their page runs into a
token-keyed tree at ``_finish``; admission matches every solo prompt
against it and *adopts* the longest cached page-aligned prefix
(``PagedKVCache.adopt_pages`` — refcount aliasing, same COW barrier),
prefilling only the remainder (always ≥1 token, so first-token sampling
still sees real final logits).  Tree leaves are reclaimed LRU-first, and
only when the allocator actually wants pages — before refusing an
admission and before preempting a live sequence.  ``resume(prev,
new_turn)`` makes multi-turn agentic episodes ride this: re-entry after a
tool call is an ordinary submission whose history prefix hits the tree.
Radix-served tokens count into ``prefill_tokens_shared`` (and thus
``g_eff``), so the scheduler prices them through the existing
``prefill_g_eff`` hook; ``radix_hit_tokens`` tracks the radix share.

AReaL semantics are preserved exactly: generation proceeds in *segments*
(``GenConfig.segment`` decode steps); at segment boundaries the engine
checks the weight store and swaps mid-sequence, every in-flight request
records the new contributing version, and a finished trajectory is
accounted against the OLDEST version it touched (the conservative choice
— ``rl.buffer`` admission keeps holding unchanged).  A forked sibling
inherits the leader's version set at fork time: its prompt K/V is the
leader's, so the leader's provenance is its provenance.

When the page pool runs dry mid-decode the youngest sequence is preempted
vLLM-style: its pages are freed and the request returns to the head of
the queue for full recomputation (work is lost, correctness is not).

The device copy of the block table is *cached*: the allocator sets
``PagedKVCache.dirty`` on any host-table mutation and the decode step
re-uploads only then (``stats.bt_uploads`` counts uploads); per-step
slot masking happens inside the step (``active`` vector), so steady
decode never re-streams the ``[max_slots, maxp]`` table to the device.

``generate(tasks)`` matches the static engine's surface (rollouts +
metrics) so launchers and trainers can swap engines; the stepwise
``submit``/``step`` API is what tests and serving drivers use to
interleave weight publishes with generation; ``generate_groups`` is the
GRPO frontend (one prefill per group).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.data.tasks import MathTask
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.rl.buffer import Rollout
from repro_torch.rl.rollout import GenConfig
from repro_torch.rl.weight_sync import WeightStore

from .kv_cache import PagedKVCache
from .model import paged_decode_step, paged_prefill_chunk
from .radix import RadixCache


@dataclass
class ServeConfig:
    max_slots: int = 8                 # concurrent sequences (decode batch)
    max_len: int = 512                 # prompt + completion cap per request
    page_size: Optional[int] = None    # None → tuned table (kernels.tuning)
    num_pages: Optional[int] = None    # None → worst case (paging never blocks)
    prefill_chunk: int = 32            # tokens per prefill call
    token_budget: Optional[int] = None # per step; None → slots + one chunk
    share_prefix: bool = True          # COW-fork identical queued prompts
    radix: bool = False                # cross-request radix prefix cache


@dataclass
class EngineStats:
    max_slots: int = 0
    decode_steps: int = 0              # batched decode invocations
    decode_slot_steps: int = 0         # Σ active slots over decode steps
    prefill_tokens: int = 0            # prompt tokens actually computed
    prefill_tokens_shared: int = 0     # prompt tokens served without compute
    radix_hit_tokens: int = 0          # ... of which came from the radix tree
    tokens_generated: int = 0          # completion tokens kept
    preempted_slot_steps: int = 0      # decode work discarded by preemption
    weight_swaps: int = 0
    admissions: int = 0
    preemptions: int = 0
    completed: int = 0
    forks: int = 0                     # sibling sequences forked
    cow_copies: int = 0                # divergent-write page copies
    bt_uploads: int = 0                # host→device block-table uploads
    wall_time_s: float = 0.0
    page_occ_sum: float = 0.0
    pool_util_sum: float = 0.0
    shared_frac_sum: float = 0.0
    occ_samples: int = 0
    gen_samples: List[Tuple[int, float]] = field(default_factory=list)

    @property
    def slot_occupancy(self) -> float:
        """Kept-token fraction of decode slot capacity — the measured analog
        of the cost model's DECODE_ENGINE_EFF 'continuous batching gaps'.
        Slot-steps a preemption discarded consumed capacity but kept
        nothing, so they count against the engine."""
        cap = self.decode_steps * self.max_slots
        kept = self.decode_slot_steps - self.preempted_slot_steps
        return kept / cap if cap else 1.0

    @property
    def page_occupancy(self) -> float:
        return (self.page_occ_sum / self.occ_samples
                if self.occ_samples else 1.0)

    @property
    def shared_page_fraction(self) -> float:
        """Mean fraction of logical page references served by shared
        physical pages — pool capacity prefix sharing saved."""
        return (self.shared_frac_sum / self.occ_samples
                if self.occ_samples else 0.0)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of logically-needed prompt tokens served by a fork
        instead of being prefilled."""
        logical = self.prefill_tokens + self.prefill_tokens_shared
        return self.prefill_tokens_shared / logical if logical else 0.0

    @property
    def g_eff(self) -> float:
        """Effective prefill amortization: logically-needed prompt tokens
        per prompt token actually computed (the scheduler divides
        C_prefill by this; 1.0 = no sharing)."""
        logical = self.prefill_tokens + self.prefill_tokens_shared
        return logical / self.prefill_tokens if self.prefill_tokens else 1.0

    @property
    def radix_hit_rate(self) -> float:
        """Fraction of logically-needed prompt tokens served from the
        cross-request radix cache (a subset of ``prefix_hit_rate``, which
        also counts in-group COW forks)."""
        logical = self.prefill_tokens + self.prefill_tokens_shared
        return self.radix_hit_tokens / logical if logical else 0.0

    def to_metrics(self) -> MetricsRegistry:
        """Export every raw count and derived rate into a fresh
        ``repro_torch.obs.metrics`` registry.  This is the typed carrier
        ``EngineReport.from_metrics`` consumes — downstream consumers
        read the registry snapshot instead of reaching into stat fields,
        so new engine internals never break the feedback loop."""
        reg = MetricsRegistry()
        for name in ("decode_steps", "decode_slot_steps", "prefill_tokens",
                     "prefill_tokens_shared", "radix_hit_tokens",
                     "tokens_generated", "preempted_slot_steps",
                     "weight_swaps", "admissions", "preemptions",
                     "completed", "forks", "cow_copies", "bt_uploads"):
            reg.counter(f"engine/{name}").inc(getattr(self, name))
        reg.gauge("engine/max_slots").set(self.max_slots)
        reg.gauge("engine/wall_time_s").set(self.wall_time_s)
        for name in ("slot_occupancy", "page_occupancy",
                     "shared_page_fraction", "prefix_hit_rate", "g_eff",
                     "radix_hit_rate"):
            reg.gauge(f"engine/{name}").set(getattr(self, name))
        return reg


@dataclass
class _Request:
    idx: int                           # submission order (rollout ordering)
    task: Any
    group_id: int
    prompt: List[int]
    max_new: int
    phash: int = 0                     # prompt-token hash (dedupe prefilter)
    temperature: float = 1.0           # per-request sampling params —
    top_p: float = 1.0                 # part of the dedupe key: identical
    greedy: bool = False               # prompts, different params ≠ one group
    state: str = "QUEUED"              # QUEUED | PREFILL | FORK | DECODE
    slot: int = -1
    prefill_done: int = 0
    tokens: List[int] = field(default_factory=list)
    logps: List[float] = field(default_factory=list)
    versions: Set[int] = field(default_factory=set)
    parent: Optional["_Request"] = None      # FORK: leader we wait on
    forks: List["_Request"] = field(default_factory=list)  # leader: waiters
    forked: bool = False               # prompt K/V came from a live fork
    radix_tokens: int = 0              # prompt tokens adopted from the tree
    t_admit: float = 0.0

    @property
    def skey(self) -> Tuple:
        """Coalescing key: prompt hash + every knob that changes what the
        engine produces for it.  Two requests alias into one fork group
        only when the whole tuple matches (prompt equality is re-checked
        against hash collisions at the comparison sites)."""
        return (self.phash, round(self.temperature, 9), round(self.top_p, 9),
                self.greedy, self.max_new)

    @property
    def plen(self) -> int:
        return len(self.prompt)

    @property
    def written(self) -> int:
        """Logical slots holding K/V (prompt + all but the last sampled)."""
        return self.plen + max(len(self.tokens) - 1, 0)

    @property
    def finished(self) -> bool:
        return bool(self.tokens) and len(self.tokens) >= self.max_new


def _nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest token set whose cumulative
    probability reaches ``top_p`` (nucleus sampling).  The top-1 token is
    always kept, so the result is never fully masked."""
    sort = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sort, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a token is kept while the mass strictly before it is < top_p
    keep = cum - probs < top_p
    cutoff = torch.amin(
        torch.where(keep, sort, torch.full_like(sort, math.inf)),
        dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, -math.inf))


class PagedEngine:
    def __init__(self, cfg: ModelConfig, store: WeightStore,
                 gen: Optional[GenConfig] = None,
                 serve: Optional[ServeConfig] = None, rng_seed: int = 0,
                 tracer=None, monitor=None, device=None):
        if cfg.family not in ("dense", "vlm"):
            raise ValueError(
                f"paged serving covers the dense-transformer family; "
                f"{cfg.family!r} models use the static RolloutEngine")
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        # wall-clock tracer, duck-typed like the reference's
        # ``repro.obs.Tracer`` (now / span / begin / end / instant /
        # counter); None = no-op, the token stream is the same either way
        self._tracer = tracer
        # wall-clock health monitor, duck-typed like the reference's
        # ``HealthMonitor`` (now / on_stage_span); None = no-op
        self._monitor = monitor
        self.gen = gen or GenConfig()
        self.serve = serve or ServeConfig()
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._params, self._version = self._fetch()
        self.kv = PagedKVCache(cfg, max_slots=self.serve.max_slots,
                               max_len=self.serve.max_len,
                               num_pages=self.serve.num_pages,
                               page_size=self.serve.page_size,
                               device=self.device)
        self.stats = EngineStats(max_slots=self.serve.max_slots)
        self.radix: Optional[RadixCache] = (RadixCache(self.kv)
                                            if self.serve.radix else None)
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}       # slot → request
        self._done: List[_Request] = []
        self._bt_dev: Optional[torch.Tensor] = None  # cached device table

    # ---------------------------------------------------------------- utils
    def _fetch(self):
        """Newest version, moved to the engine's device once per fetch."""
        tree, version = self.store.fetch(dtype=self.cfg.tdtype)
        return params_from_jax(tree, self.device), version

    def _draw(self, scaled: torch.Tensor) -> torch.Tensor:
        """One categorical draw per row of ``scaled`` logits [N, V]."""
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=self._rng)[:, 0]

    def _sample(self, logits: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray]:
        """logits [S, padded_vocab] → (token ids, chosen logps) on the host,
        using the engine-wide defaults — the batched fast path when no
        request in the batch overrides its sampling params.  One copy
        brings both back."""
        logits = logits[..., :self.cfg.vocab].float()
        if self.gen.greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = self._draw(logits / self.gen.temperature)
        logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            tok[:, None])[:, 0]
        # token ids < 2^24 are exact in float64, as float32 log-probs are
        host = torch.stack([tok.double(), logp.double()]).cpu().numpy()
        return host[0].astype(np.int32), host[1].astype(np.float32)

    def _sample_req(self, logits: torch.Tensor,
                    req: "_Request") -> Tuple[int, float]:
        """Single-row sample honoring ``req``'s own temperature / top_p /
        greedy.  With engine-default params this computes what ``_sample``
        would, so default requests stay token-identical through either
        path."""
        logits = logits[None, :self.cfg.vocab].float()
        if req.greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            scaled = logits / req.temperature
            if req.top_p < 1.0:
                scaled = _nucleus_filter(scaled, req.top_p)
            tok = self._draw(scaled)
        logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            tok[:, None])[:, 0]
        host = torch.stack([tok.double(), logp.double()]).cpu().numpy()
        return int(host[0, 0]), float(np.float32(host[1, 0]))

    def _default_params(self, req: "_Request") -> bool:
        return (req.temperature == self.gen.temperature
                and req.top_p == getattr(self.gen, "top_p", 1.0)
                and req.greedy == self.gen.greedy)

    def _maybe_swap_weights(self) -> None:
        if self.store.version > self._version:
            self._params, self._version = self._fetch()
            self.stats.weight_swaps += 1
            if self._tracer is not None:
                self._tracer.instant("engine", "weights", "swap",
                                     self._tracer.now(),
                                     version=self._version)
            for r in self._active.values():
                r.versions.add(self._version)
            if self.radix is not None:
                # cached K/V was computed under the old weights; a NEW
                # request adopting it would silently inherit stale
                # provenance its version set doesn't record.  In-flight
                # sequences keep decoding over their own pages (AReaL
                # mid-sequence-swap semantics, unchanged) — only the
                # cross-request tree is dropped.
                self.radix.reset()

    # ------------------------------------------------------------ admission
    def submit(self, tasks: Sequence[MathTask], *, group_offset: int = 0,
               max_new_per_task: Optional[Sequence[int]] = None,
               group_ids: Optional[Sequence[int]] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               greedy: Optional[bool] = None) -> None:
        """Enqueue one request per task.  ``temperature``/``top_p``/
        ``greedy`` override the engine defaults for THESE requests only;
        admission dedupe keys on (prompt, sampling params, max_new), so an
        identical prompt submitted with different params gets its own
        prefill group instead of aliasing to the first one's leader."""
        base = len(self._queue) + len(self._active) + len(self._done)
        temp = self.gen.temperature if temperature is None else temperature
        tp = (getattr(self.gen, "top_p", 1.0) if top_p is None else top_p)
        gr = self.gen.greedy if greedy is None else greedy
        for j, t in enumerate(tasks):
            max_new = (self.gen.max_new_tokens if max_new_per_task is None
                       else int(max_new_per_task[j]))
            total = len(t.prompt_ids) + max_new
            if total > self.serve.max_len:
                raise ValueError(f"request needs {total} > "
                                 f"max_len={self.serve.max_len} slots")
            if self.kv.pages_needed(total) > self.kv.num_pages - 1:
                raise ValueError("pool smaller than one full sequence")
            gid = (group_offset + j) if group_ids is None else int(group_ids[j])
            prompt = list(t.prompt_ids)
            self._queue.append(_Request(idx=base + j, task=t, group_id=gid,
                                        prompt=prompt, max_new=max_new,
                                        phash=hash(tuple(prompt)),
                                        temperature=temp, top_p=tp,
                                        greedy=gr))

    def submit_group(self, task: MathTask, group_size: int, *,
                     group_id: int = 0,
                     max_new: Optional[int] = None,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None,
                     greedy: Optional[bool] = None) -> None:
        """Enqueue one GRPO group: ``group_size`` completions of ONE
        prompt.  Admission coalesces them into a single prefill plus
        ``group_size − 1`` COW forks (when ``serve.share_prefix``)."""
        mnew = None if max_new is None else [max_new] * group_size
        self.submit([task] * group_size, group_ids=[group_id] * group_size,
                    max_new_per_task=mnew, temperature=temperature,
                    top_p=top_p, greedy=greedy)

    def resume(self, prev, new_turn: Sequence[int], *,
               task: Optional[MathTask] = None,
               group_id: Optional[int] = None,
               max_new: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               greedy: Optional[bool] = None) -> None:
        """Re-enter a multi-turn conversation after a tool call: enqueue a
        request whose prompt is the full history plus ``new_turn``.

        ``prev`` is either the previous turn's ``Rollout`` (history =
        its prompt + completion) or a raw token history.  This is just a
        submission — with ``serve.radix`` on, admission matches the
        history against the tree (the previous turn's pages were inserted
        at ``_finish``) and prefills only the page-tail + ``new_turn``
        delta; with radix off it degrades to a full re-prefill, token-
        identically."""
        if isinstance(prev, Rollout):
            history = list(prev.prompt_ids) + list(prev.completion_ids)
            task = prev.task if task is None else task
            group_id = prev.group_id if group_id is None else group_id
        else:
            history = list(prev)
        prompt = history + list(new_turn)
        if task is None:
            raise ValueError("resume from raw tokens needs an explicit task")
        t = dataclasses.replace(task, prompt_ids=list(prompt))
        if self._tracer is not None:
            self._tracer.instant("engine", "admission", "resume",
                                 self._tracer.now(),
                                 history=len(history),
                                 delta=len(new_turn))
        self.submit([t], group_ids=[group_id or 0],
                    max_new_per_task=None if max_new is None else [max_new],
                    temperature=temperature, top_p=top_p, greedy=greedy)

    def _admit(self, now: float) -> None:
        while self._queue and self.kv.free_slots:
            req = self._queue[0]
            if self.serve.share_prefix:
                leader = self._prefilling_leader_for(req)
                if leader is not None:
                    # a fork (≤1 tail-page COW copy) always beats a
                    # duplicate prefill: attach when headroom allows,
                    # otherwise WAIT — admitting a second leader for the
                    # same prompt would recompute the prompt at HIGHER
                    # page cost than the fork we just refused
                    if (self.kv.free_pages < len(leader.forks) + 2
                            and not self._radix_evict(
                                len(leader.forks) + 2 - self.kv.free_pages)):
                        break
                    if self.kv.free_pages < len(leader.forks) + 2:
                        break
                    self._queue.pop(0)
                    self._admit_fork(leader, req, now)
                    continue
            # longest cached prefix from the radix tree, capped one token
            # short of the full prompt (the final logits must come from a
            # real prefill for first-token sampling to work)
            hit_pages: List[int] = []
            hit = 0
            if self.radix is not None and req.plen > 1:
                pages, n = self.radix.match(req.prompt)
                hit = min(n, ((req.plen - 1) // self.kv.page) * self.kv.page)
                hit_pages = pages[:hit // self.kv.page]
            # prompt pages + one decode-headroom page — but never demand
            # more than the request will EVER need, or a short-completion
            # request whose total exactly fits the pool could never admit
            need = min(self.kv.pages_needed(req.plen) + 1,
                       self.kv.pages_needed(req.plen + req.max_new))
            need -= len(hit_pages)
            if self.kv.free_pages < need:
                # the tree's retained-but-idle leaves are reclaimable
                # capacity: evict before refusing admission (adopted pages
                # are on the match path, never LRU leaves of other runs —
                # but a stale match could still lose its node, so re-match
                # below if eviction ran)
                if not self._radix_evict(need - self.kv.free_pages):
                    break
                if hit_pages:
                    pages, n = self.radix.match(req.prompt)
                    hit = min(n,
                              ((req.plen - 1) // self.kv.page) * self.kv.page)
                    hit_pages = pages[:hit // self.kv.page]
                    need = min(self.kv.pages_needed(req.plen) + 1,
                               self.kv.pages_needed(req.plen + req.max_new))
                    need -= len(hit_pages)
                if self.kv.free_pages < need:
                    break
            self._queue.pop(0)
            slot = self.kv.alloc_slot()
            if hit_pages:
                self.kv.adopt_pages(slot, hit_pages, hit)
            ok = self.kv.ensure(slot, req.plen)
            assert ok, "admission checked free_pages"
            req.slot, req.state = slot, "PREFILL"
            req.prefill_done = hit
            req.radix_tokens = hit
            req.t_admit = now
            req.versions = {self._version}
            self._active[slot] = req
            self.stats.admissions += 1
            if self._tracer is not None:
                self._tracer.instant("engine", "admission", "admit",
                                     self._tracer.now(), slot=slot,
                                     radix_hit_tokens=hit,
                                     queued=len(self._queue))
            # radix-served prompt tokens are shared-prefill credit exactly
            # like fork-served ones: g_eff (and through it the scheduler's
            # prefill_g_eff) prices both with the same machinery
            self.stats.prefill_tokens_shared += hit
            self.stats.radix_hit_tokens += hit
            if self.serve.share_prefix:
                self._coalesce(req, now)

    def _radix_evict(self, need: int) -> int:
        """Reclaim ``need`` pages from the radix tree's idle leaves (0 when
        no tree, nothing evictable, or ``need`` non-positive)."""
        if self.radix is None or need <= 0:
            return 0
        return self.radix.evict(need)

    def _prefilling_leader_for(self, req: _Request) -> Optional[_Request]:
        """An active mid-prefill request with the same prompt AND sampling
        params, if any (once a leader starts decoding its prompt logits
        are gone, so late arrivals can no longer fork from it)."""
        return next((r for r in self._active.values()
                     if r.state == "PREFILL" and r.skey == req.skey
                     and r.prompt == req.prompt), None)

    def _admit_fork(self, leader: _Request, sib: _Request,
                    now: float) -> None:
        """Admit ``sib`` as a FORK sibling of ``leader``: it holds a slot
        (reserved now) but no pages, skips prefill entirely, and forks
        the leader's pages when its prefill completes."""
        slot = self.kv.alloc_slot()
        sib.slot, sib.state = slot, "FORK"
        sib.parent = leader
        sib.t_admit = now
        sib.versions = {self._version}
        leader.forks.append(sib)
        self._active[slot] = sib
        self.stats.admissions += 1
        if self._tracer is not None:
            self._tracer.instant("engine", "admission", "admit_fork",
                                 self._tracer.now(), slot=slot,
                                 leader=leader.slot)

    def _coalesce(self, leader: _Request, now: float) -> None:
        """Scan the queue for requests with the SAME prompt and sampling
        params as the just-admitted ``leader`` and attach them as FORK
        siblings.  Each
        sibling admitted keeps ~1 page of headroom free for its tail-page
        COW copy (preemption covers misestimates)."""
        i = 0
        while i < len(self._queue):
            sib = self._queue[i]
            if sib.skey != leader.skey or sib.prompt != leader.prompt:
                i += 1
                continue
            if (not self.kv.free_slots
                    or self.kv.free_pages < len(leader.forks) + 2):
                break
            self._queue.pop(i)
            self._admit_fork(leader, sib, now)

    # ------------------------------------------------------------- eviction
    def _finish(self, req: _Request, now: float) -> None:
        if self.radix is not None:
            # retain the finished sequence's full pages in the tree BEFORE
            # freeing the slot, so the conversation's K/V survives for the
            # next turn's resume().  K/V is written for positions
            # 0..written−1 (prompt + all but the last sampled token);
            # insert() truncates to whole pages itself.
            seq = (req.prompt + req.tokens)[:req.written]
            self.radix.insert(seq, self.kv._pages_of[req.slot])
        self.kv.free_slot(req.slot)
        del self._active[req.slot]
        req.slot = -1
        self._done.append(req)
        self.stats.completed += 1
        self.stats.gen_samples.append((len(req.tokens), now - req.t_admit))
        if self._tracer is not None:
            self._tracer.instant("engine", "admission", "finish",
                                 self._tracer.now(),
                                 tokens=len(req.tokens),
                                 latency_s=now - req.t_admit)

    def _preempt_youngest(self) -> bool:
        """Pool exhausted: kick the most recently admitted sequence back to
        the queue head for recomputation (vLLM recompute policy).  Decoding,
        mid-prefill and fork-waiting sequences are all candidates — only the
        oldest decoding sequence is protected, so forward progress is
        guaranteed.  A preempted leader drags its pending forks back to the
        queue with it (they hold no pages, only slots); a preempted fork
        detaches from its leader and recomputes solo."""
        decoding = [r for r in self._active.values() if r.state == "DECODE"]
        protected = (min(decoding, key=lambda r: (r.t_admit, r.idx))
                     if decoding else None)
        victims = [r for r in self._active.values() if r is not protected]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (r.t_admit, r.idx))
        group = [victim] + list(victim.forks)
        # detach the victim from ITS leader (if it is a pending fork)
        # before touching the group: the group members' own parent is the
        # victim, whose forks list is about to be cleared wholesale
        if victim.parent is not None:
            victim.parent.forks.remove(victim)
        for req in group:
            req.parent = None
            req.forks = []
            self.kv.free_slot(req.slot)
            del self._active[req.slot]
            req.slot = -1
            req.state = "QUEUED"
            req.prefill_done = 0
            # the victim's tokens are discarded and recomputed: un-count
            # them so kept-token metrics (occupancy, tokens/s) stay honest
            self.stats.tokens_generated -= len(req.tokens)
            self.stats.preempted_slot_steps += max(len(req.tokens) - 1, 0)
            req.tokens, req.logps = [], []
            if req.forked:
                # its forked prompt K/V is gone and will be recomputed —
                # void the shared-prefill credit, or g_eff would overstate
                # sharing to the scheduler exactly when preemption thrash
                # makes sharing least effective
                self.stats.prefill_tokens_shared -= req.plen
                req.forked = False
            if req.radix_tokens:
                # same honesty rule for radix-served prompt tokens: the
                # adopted pages are released with the slot, so the credit
                # is void (re-admission re-matches and re-credits)
                self.stats.prefill_tokens_shared -= req.radix_tokens
                self.stats.radix_hit_tokens -= req.radix_tokens
                req.radix_tokens = 0
        self._queue[:0] = group
        self.stats.preemptions += 1
        if self._tracer is not None:
            self._tracer.instant("engine", "admission", "preempt",
                                 self._tracer.now(), group=len(group),
                                 free_pages=self.kv.free_pages)
        return True

    # ----------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration (admit → decode → prefill → evict).
        Returns False when nothing is left to do."""
        if not (self._queue or self._active):
            return False
        now = time.time()
        tr = self._tracer
        if tr is not None:
            tr.begin("engine", "loop", "step", tr.now(),
                     queued=len(self._queue), active=len(self._active))
        self._admit(now)
        try:
            return self._step_body(now)
        finally:
            # wall time accrues per step so the stepwise submit/step/collect
            # path reports real lifetime throughput, not 0
            self.stats.wall_time_s += time.time() - now
            if tr is not None:
                tr.end("engine", "loop", tr.now())

    def _step_body(self, now: float) -> bool:
        decode_slots = sorted(s for s, r in self._active.items()
                              if r.state == "DECODE")
        budget = (self.serve.token_budget
                  or self.serve.max_slots + self.serve.prefill_chunk)

        if decode_slots:
            # every sequence is about to write one token: COW-privatize the
            # target page and grow the table to cover it; preempt
            # youngest-first until the pool covers the rest
            while True:
                lacking = [
                    s for s in decode_slots
                    if not (self.kv.writable(s, self._active[s].written)
                            and self.kv.ensure(s, self._active[s].written + 1))
                ]
                if not lacking:
                    break
                # idle radix leaves are cheaper to reclaim than a live
                # sequence's work: evict before preempting
                if self._radix_evict(len(lacking)):
                    continue
                if not self._preempt_youngest():
                    raise RuntimeError(
                        "page pool exhausted with a single sequence active "
                        "— num_pages cannot cover max_len")
                decode_slots = [s for s in decode_slots if s in self._active]
            if decode_slots:
                self._decode_batch(decode_slots, now)
                budget -= len(decode_slots)

        for slot in sorted(s for s, r in self._active.items()
                           if r.state == "PREFILL"):
            if budget <= 0:
                break
            budget -= self._prefill_one(self._active[slot])

        for slot in sorted(self._active):
            req = self._active[slot]
            if req.state == "DECODE" and req.finished:
                self._finish(req, now)
        self.stats.cow_copies = self.kv.cow_copies
        return True

    def _decode_batch(self, slots: List[int], now: float) -> None:
        tr = self._tracer
        t0 = tr.now() if tr is not None else 0.0
        mon = self._monitor
        m0 = mon.now() if mon is not None else 0.0
        if self.stats.decode_steps % max(self.gen.segment, 1) == 0:
            self._maybe_swap_weights()
        S = self.serve.max_slots
        # rows: token, position (the slot the token lands in), active
        host = np.zeros((3, S), np.int32)
        for s in slots:
            r = self._active[s]
            host[:, s] = (r.tokens[-1], r.written, 1)
        # the device block table is cached: re-upload only when the
        # allocator mutated the host copy; inactive-slot masking happens
        # inside the step (null-page routing), not by editing rows.  The
        # upload copies: a tensor aliasing the host array would follow
        # every host edit without an upload.
        if self.kv.dirty or self._bt_dev is None:
            self._bt_dev = torch.tensor(self.kv.block_tables,
                                        device=self.device)
            self.kv.dirty = False
            self.stats.bt_uploads += 1
        token, pos, active = torch.from_numpy(host).to(self.device)
        # the longest row (positions + 1), known here: K2's split count
        # runs over it instead of the table's width
        logits, self.kv.k_pages, self.kv.v_pages = paged_decode_step(
            self._params, self.cfg, self.kv.k_pages, self.kv.v_pages,
            self._bt_dev, token, pos, active,
            max_len=int(host[1].max()) + 1)
        if all(self._default_params(self._active[s]) for s in slots):
            arr_toks, arr_logps = self._sample(logits)
            toks = {s: int(arr_toks[s]) for s in slots}
            logps = {s: float(arr_logps[s]) for s in slots}
        else:
            # at least one row overrides its sampling params: sample rows
            # individually (slow path; the default-config stream above is
            # unchanged by it)
            toks, logps = {}, {}
            for s in slots:
                toks[s], logps[s] = self._sample_req(logits[s],
                                                     self._active[s])
        for s in slots:
            r = self._active[s]
            r.tokens.append(toks[s])
            r.logps.append(logps[s])
            self.kv.seq_lens[s] = r.written
            self.stats.tokens_generated += 1
            if r.tokens[-1] == self.gen.eos_id:
                r.max_new = len(r.tokens)               # stop this row
        self.stats.decode_steps += 1
        self.stats.decode_slot_steps += len(slots)
        occ = self.kv.occupancy()
        self.stats.page_occ_sum += occ["page_occupancy"]
        self.stats.pool_util_sum += occ["pool_util"]
        self.stats.shared_frac_sum += occ["shared_frac"]
        self.stats.occ_samples += 1
        if tr is not None:
            tr.span("engine", "decode", "decode_step", t0, tr.now() - t0,
                    slots=len(slots))
            tr.counter("engine", "pages", tr.now(),
                       free=self.kv.free_pages,
                       occupancy=occ["page_occupancy"])
        if mon is not None:
            mon.on_stage_span("decode", m0, mon.now() - m0)

    def _fork_siblings(self, leader: _Request, last_logits: torch.Tensor,
                       now: float) -> None:
        """Leader's prefill just completed: alias each waiting sibling's
        block table onto the leader's prompt pages and sample its own
        first token from the shared prompt logits.  No prefill compute,
        no K/V movement — divergence is handled page-locally by the COW
        barrier when siblings start writing."""
        for sib in list(leader.forks):
            got = self.kv.fork_slot(leader.slot, leader.plen, child=sib.slot)
            assert got == sib.slot
            tok, logp = self._sample_req(last_logits, sib)
            sib.tokens.append(tok)
            sib.logps.append(logp)
            sib.state = "DECODE"
            sib.parent = None
            sib.forked = True
            # the sibling's prompt K/V is the leader's: the leader's
            # version provenance is its provenance (conservative superset)
            sib.versions = set(leader.versions)
            self.kv.seq_lens[sib.slot] = sib.plen
            self.stats.tokens_generated += 1
            self.stats.prefill_tokens_shared += sib.plen
            self.stats.forks += 1
            if sib.tokens[-1] == self.gen.eos_id:
                sib.max_new = 1                       # EOS straight away
        leader.forks = []

    def _prefill_one(self, req: _Request) -> int:
        tr = self._tracer
        t0 = tr.now() if tr is not None else 0.0
        mon = self._monitor
        m0 = mon.now() if mon is not None else 0.0
        chunk = self.serve.prefill_chunk
        n = min(chunk, req.plen - req.prefill_done)
        toks = np.zeros((chunk,), np.int32)
        toks[:n] = req.prompt[req.prefill_done:req.prefill_done + n]
        # pad rows write past the prompt: beyond the allocated pages they
        # land in the null page, inside them they hit slots this sequence
        # overwrites at exactly those positions later, and every read masks
        # by current length — unobservable either way
        ok = self.kv.ensure(req.slot, req.plen)
        assert ok, "admission reserved these"
        # one upload: the slot's table row, then the chunk's tokens (a
        # fresh array, so nothing aliases the host table on the CPU)
        host = np.concatenate([self.kv.block_tables[req.slot], toks])
        dev = torch.from_numpy(host).to(self.device)
        maxp = self.kv.maxp
        logits, self.kv.k_pages, self.kv.v_pages = paged_prefill_chunk(
            self._params, self.cfg, self.kv.k_pages, self.kv.v_pages,
            dev[:maxp], dev[maxp:], req.prefill_done)
        req.prefill_done += n
        self.stats.prefill_tokens += n
        if req.prefill_done >= req.plen:
            first, logp = self._sample_req(logits[n - 1], req)
            req.tokens.append(first)
            req.logps.append(logp)
            req.state = "DECODE"
            self.kv.seq_lens[req.slot] = req.plen
            self.stats.tokens_generated += 1
            if req.tokens[-1] == self.gen.eos_id:
                req.max_new = 1                       # EOS straight away
            if req.forks:
                self._fork_siblings(req, logits[n - 1], time.time())
        if tr is not None:
            tr.span("engine", "prefill", "prefill_chunk", t0,
                    tr.now() - t0, tokens=n, slot=req.slot)
        if mon is not None:
            mon.on_stage_span("prefill", m0, mon.now() - m0)
        return n

    # -------------------------------------------------------------- frontend
    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._active)

    def drain(self) -> None:
        while self.step():
            pass

    @torch.no_grad()
    def quiesce(self) -> int:
        """Drain to a checkpointable boundary: run steps *without admitting
        anything new* until no active request is mid-prefill (or a FORK
        waiting on one), so a snapshot taken afterwards never captures a
        half-prefilled request.  DECODE-state requests are fine to capture
        — their KV is complete up to ``written`` and the next token is a
        pure function of restored state.  Returns the number of steps run;
        queued-but-unadmitted requests stay queued."""
        steps = 0
        while any(r.state in ("PREFILL", "FORK")
                  for r in self._active.values()):
            now = time.time()
            self._step_body(now)
            self.stats.wall_time_s += time.time() - now
            steps += 1
        return steps

    def collect(self, since: int = 0) -> Tuple[List[Rollout], Dict]:
        """Package finished requests (submission order) into rollouts +
        *lifetime* engine metrics — the stepwise counterpart of
        ``generate`` (which reports per-call deltas)."""
        return self._package(since, wall_s=self.stats.wall_time_s,
                             base=EngineStats(max_slots=self.serve.max_slots))

    def generate(self, tasks: Sequence[MathTask], *, group_offset: int = 0,
                 max_new_per_task: Optional[Sequence[int]] = None,
                 ) -> Tuple[List[Rollout], Dict]:
        """Static-engine-compatible frontend: one completion per task.
        Metrics are per-call deltas, like the static engine's."""
        t0 = time.time()
        n_before = len(self._done)
        base = dataclasses.replace(self.stats, gen_samples=[])
        self.submit(tasks, group_offset=group_offset,
                    max_new_per_task=max_new_per_task)
        self.drain()               # step() accrues stats.wall_time_s itself
        dt = time.time() - t0
        return self._package(n_before, wall_s=dt, base=base)

    def generate_groups(self, tasks: Sequence[MathTask], group_size: int, *,
                        group_ids: Optional[Sequence[int]] = None,
                        ) -> Tuple[List[Rollout], Dict]:
        """GRPO frontend: ``group_size`` completions per task, one prefill
        per group (prompt pages COW-shared across the siblings).  Rollouts
        come back grouped (task-major), metrics are per-call deltas."""
        t0 = time.time()
        n_before = len(self._done)
        base = dataclasses.replace(self.stats, gen_samples=[])
        for j, t in enumerate(tasks):
            gid = j if group_ids is None else int(group_ids[j])
            self.submit_group(t, group_size, group_id=gid)
        self.drain()
        return self._package(n_before, wall_s=time.time() - t0, base=base)

    def _package(self, since: int, *, wall_s: float,
                 base: "EngineStats") -> Tuple[List[Rollout], Dict]:
        new = sorted(self._done[since:], key=lambda r: r.idx)
        rollouts, versions_used = [], set()
        for r in new:
            versions_used |= r.versions
            comp = list(r.tokens)
            if self.gen.eos_id in comp:                # cut at first EOS
                comp = comp[:comp.index(self.gen.eos_id) + 1]
            rollouts.append(Rollout(
                prompt_ids=list(r.prompt),
                completion_ids=comp,
                behavior_logp=np.asarray(r.logps[:len(comp)], np.float32),
                version=min(r.versions),               # conservative staleness
                group_id=r.group_id,
                task=r.task,
            ))
        st = self.stats
        steps = st.decode_steps - base.decode_steps
        slot_steps = st.decode_slot_steps - base.decode_slot_steps
        kept_steps = slot_steps - (st.preempted_slot_steps
                                   - base.preempted_slot_steps)
        occ_n = st.occ_samples - base.occ_samples
        tokens = st.tokens_generated - base.tokens_generated
        pf = st.prefill_tokens - base.prefill_tokens
        pf_shared = st.prefill_tokens_shared - base.prefill_tokens_shared
        radix_tok = st.radix_hit_tokens - base.radix_hit_tokens
        metrics = {
            "weight_swaps": st.weight_swaps - base.weight_swaps,
            "versions": sorted(versions_used),
            "mean_len": (float(np.mean([len(r.completion_ids)
                                        for r in rollouts]))
                         if rollouts else 0.0),
            "decode_steps": steps,
            "decode_slot_steps": slot_steps,
            "prefill_tokens": pf,
            "prefill_tokens_shared": pf_shared,
            "prefix_hit_rate": pf_shared / (pf + pf_shared)
                               if pf + pf_shared else 0.0,
            "radix_hit_tokens": radix_tok,
            "radix_hit_rate": radix_tok / (pf + pf_shared)
                              if pf + pf_shared else 0.0,
            "g_eff": (pf + pf_shared) / pf if pf else 1.0,
            "forks": st.forks - base.forks,
            "cow_copies": st.cow_copies - base.cow_copies,
            "bt_uploads": st.bt_uploads - base.bt_uploads,
            "slot_occupancy": (kept_steps / (steps * st.max_slots)
                               if steps else 1.0),
            "page_occupancy": ((st.page_occ_sum - base.page_occ_sum) / occ_n
                               if occ_n else 1.0),
            "shared_page_fraction": ((st.shared_frac_sum
                                      - base.shared_frac_sum) / occ_n
                                     if occ_n else 0.0),
            "preemptions": st.preemptions - base.preemptions,
            "tokens_per_sec": tokens / wall_s if wall_s > 0 else 0.0,
        }
        return rollouts, metrics
