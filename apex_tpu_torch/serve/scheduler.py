"""Continuous-batching scheduler of the port (``apex_tpu/serve/
scheduler.py``): admit / evict / preempt at step granularity, with
capacity accounted in pool pages.

Pure host-side state machine (no torch), with the JAX package's policy and
order — the vLLM recompute-preemption shape:

- **FCFS admission**: waiting sequences admit in arrival order, when a
  batch slot is free AND the allocator can cover the sequence's current
  tokens plus the next decode write. Head-of-line blocking is deliberate.
- **On-demand growth**: a running sequence takes one page exactly when its
  next decode position crosses a page boundary.
- **Evict-on-exhaustion**: when growth cannot be served, the LATEST-arrived
  running sequence is preempted — its pages are freed and it returns to
  the waiting queue, sorted by arrival, *keeping its generated tokens*.
  Re-admission recomputes the cache (prefill of the prompt + decode-replay
  of the generated tokens), which is why preempt/resume is bit-exact.

With speculative decoding the engine passes ``lookahead = spec_k``: a
round writes up to that many positions past the next decode position (the
verify window), so growth and admission cover them up front.

Page 0 of the pool is the null page and is never allocated. The JAX
scheduler's telemetry (spans, queue-wait histograms) comes with a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


@dataclasses.dataclass
class Sequence:
    """One request's full lifecycle state."""

    seq_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival: int = 0
    state: str = WAITING
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None         # engine batch slot while RUNNING
    num_cached: int = 0                # positions with K/V in the pool
    draft_cached: int = 0              # positions in the DRAFT pool
    n_preemptions: int = 0

    def __post_init__(self):
        if not self.prompt:
            raise ValueError("empty prompt")
        if not self.tokens:
            self.tokens = list(self.prompt)

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - len(self.prompt)

    @property
    def done(self) -> bool:
        return self.num_generated >= self.max_new_tokens


class PageAllocator:
    """Free-list over pages ``1..num_pages-1`` (0 is the null page)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> low ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"freeing invalid page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)


@dataclasses.dataclass
class StepPlan:
    """What the engine runs this step: prefills first (each a full-prompt
    pass + any decode-replay of generated tokens), then one batched decode
    over every running sequence."""

    prefill: List[Sequence] = dataclasses.field(default_factory=list)
    decode: List[Sequence] = dataclasses.field(default_factory=list)
    preempted: List[Sequence] = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, *, num_pages: int, page_size: int, max_batch: int,
                 lookahead: int = 0):
        self.allocator = PageAllocator(num_pages)
        self.page_size = page_size
        self.max_batch = max_batch
        # speculative decoding writes up to ``lookahead`` positions past the
        # next decode position in one round; a preemption in mid-window
        # would strand a half-written round
        self.lookahead = int(lookahead)
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self._arrival = 0

    # -- bookkeeping -------------------------------------------------

    def add(self, seq: Sequence) -> None:
        seq.arrival = self._arrival
        self._arrival += 1
        seq.state = WAITING
        self.waiting.append(seq)

    def finish(self, seq: Sequence) -> None:
        seq.state = FINISHED
        self.running.remove(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.slot = None
        seq.num_cached = 0
        seq.draft_cached = 0

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def preempt(self, seq: Sequence) -> None:
        """Return a running sequence to the waiting queue, freeing its
        pages; its tokens survive."""
        seq.state = WAITING
        seq.n_preemptions += 1
        self.running.remove(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.slot = None
        seq.num_cached = 0
        # the draft pool reuses the target's page ids, so eviction
        # invalidates the draft cache too: re-admission re-ingests
        seq.draft_cached = 0
        # back of the ARRIVAL order, front of readmission among later
        # arrivals: waiting stays sorted by arrival
        self.waiting.append(seq)
        self.waiting.sort(key=lambda s: s.arrival)

    # -- the per-step policy -----------------------------------------

    def schedule(self) -> StepPlan:
        plan = StepPlan()

        # 1. growth: every running sequence must hold pages for its next
        # decode write (position num_tokens-1) plus the lookahead window.
        # Earliest arrivals are served first; exhaustion preempts the LATEST-arrived running
        # sequence — possibly the grower itself, when it is the latest.
        for seq in sorted(self.running, key=lambda s: s.arrival):
            if seq.state != RUNNING:
                continue                    # preempted earlier this pass
            grown = True
            want = self._pages_needed(seq.num_tokens + self.lookahead)
            while want > len(seq.pages):
                need = want - len(seq.pages)
                got = self.allocator.alloc(need)
                if got is not None:
                    seq.pages.extend(got)
                    break
                victim = max(self.running, key=lambda s: s.arrival)
                self.preempt(victim)
                plan.preempted.append(victim)
                if victim is seq:
                    grown = False
                    break
            if grown and seq.state == RUNNING:
                plan.decode.append(seq)

        # 2. FCFS admission into free slots/pages. A resumed sequence needs
        # pages for ALL its tokens (prompt + generated: the recompute) plus
        # the next write.
        while self.waiting and len(self.running) < self.max_batch:
            seq = self.waiting[0]
            need = self._pages_needed(seq.num_tokens + 1 + self.lookahead)
            if need > self.allocator.num_pages - 1:
                raise RuntimeError(
                    f"sequence {seq.seq_id} needs {need} pages; the pool "
                    f"has {self.allocator.num_pages - 1} usable — it can "
                    f"never be admitted (grow num_pages or page_size)")
            got = self.allocator.alloc(need)
            if got is None:
                break                       # head-of-line: no skip-ahead
            self.waiting.pop(0)
            seq.pages = got
            seq.state = RUNNING
            self.running.append(seq)
            plan.prefill.append(seq)
        return plan
