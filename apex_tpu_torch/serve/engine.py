"""The serve engine of the port (``apex_tpu/serve/engine.py``): prefill and
decode steps over an in-place paged cache, driven by the continuous-batching
scheduler.

Shape discipline, as in the JAX engine: the prefill step runs one sequence
at the static padded prompt length (``max_prompt_len``); the decode step
runs the full fixed-capacity batch (``max_batch`` slots, inactive slots
routed to the null page). No operation in the forward mixes batch rows and
every step runs at one shape, so a slot's row is a function of that slot's
inputs alone — which is why replaying a preempted sequence's generated
tokens through the decode step reproduces its cache and logits bit-exactly.
The cache pool is updated in place (the JAX engine donates it): one pool
is resident, never two.

Sampling is greedy argmax. Kernels are chosen by the device: on CUDA the
flash-prefill, paged-decode, LayerNorm and fp8 dequant-matmul kernels run,
on the CPU their plain versions.

fp8 (as in the JAX engine):

- ``fp8_weights=True`` quantizes the block linears' kernels once, at
  build, to e4m3 with one scale each
  (:func:`~apex_tpu_torch.serve.model.quantize_gpt_weights`); every
  prefill and decode step streams them through the fp8 dequant-matmul.
  The caller's GPT is left as it was.
- ``fp8_kv=True`` keeps the pool in e4m3 with one scale per (layer, head,
  page), set by the page's slot-0 token (:mod:`~apex_tpu_torch.serve.
  cache`); decode attends through the fp8 variant of the paged-decode
  kernel.

Speculative decoding (``spec_k > 0``, :mod:`~apex_tpu_torch.serve.spec`):
a depth-truncated draft (``draft_num_layers``, default half the layers, or
``draft_cfg``/``draft_params``) proposes ``k`` tokens per round through its
own pool, which mirrors the target pool's geometry so that each sequence's
block table serves both; the target verifies the ``k+1`` positions in one
call of the decode step (rows ``0..k`` of the batch). It composes with
fp8 weights (the draft shares the quantized blocks) and is refused with
fp8 KV: the slot-0 scale rule needs sequential writes, and a verify window
crossing a page boundary would write two scales to one page in one call.

Not ported yet (each raises ``NotImplementedError``): tensor parallelism
and the serve telemetry (spans, metrics export, flight dumps).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch._compat import DeviceLike, resolve_device
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.serve import cache as cache_mod
from apex_tpu_torch.serve import model as model_mod
from apex_tpu_torch.serve import spec as spec_mod
from apex_tpu_torch.serve.scheduler import RUNNING, Scheduler, Sequence


def _check_params(params, device: torch.device) -> None:
    if params.device.type != device.type:
        raise ValueError(f"params lie on {params.device}, the engine runs "
                         f"on {device}")


class ServeEngine:
    """Paged-KV-cache GPT serving on one device.

    ``params`` is the port's :class:`~apex_tpu_torch.models.gpt.GPT`.
    ``device`` defaults to CUDA and raises without it; pass ``"cpu"`` to
    serve through the kernels' plain versions.
    """

    def __init__(self, cfg: GPTConfig, params: GPT, *, num_pages: int,
                 max_seq_len: int, max_prompt_len: int,
                 page_size: Optional[int] = None, max_batch: int = 4,
                 record_logits: bool = False, device: DeviceLike = None,
                 fp8_kv: bool = False, fp8_margin: float = 2.0,
                 spec_k: int = 0, draft_num_layers: Optional[int] = None,
                 draft_cfg: Optional[GPTConfig] = None, draft_params=None,
                 fp8_weights: bool = False, fp8_weight_margin: float = 0.0):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self.fp8_weights = bool(fp8_weights)
        if fp8_weights:
            with torch.no_grad():
                params = model_mod.quantize_gpt_weights(
                    cfg, params, margin=fp8_weight_margin)
        self.params = params
        psize = cache_mod.resolve_page_size(context_len=max_seq_len,
                                            page_size=page_size)
        if max_seq_len > cfg.max_seq_len:
            raise ValueError(f"max_seq_len {max_seq_len} exceeds the "
                             f"model's {cfg.max_seq_len}")
        if max_prompt_len > max_seq_len:
            raise ValueError("max_prompt_len exceeds max_seq_len")
        self.max_seq_len = max_seq_len
        self.max_prompt_len = max_prompt_len
        self.pages_per_seq = -(-max_seq_len // psize)
        self.ccfg = cache_mod.CacheConfig(
            num_layers=cfg.num_layers, kv_heads=cfg.num_heads,
            head_dim=cfg.head_dim, num_pages=num_pages, page_size=psize,
            dtype=cfg.dtype, fp8=fp8_kv, fp8_margin=fp8_margin)
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k:
            if self.spec_k + 1 > max_batch:
                raise ValueError(
                    f"spec_k={spec_k} needs max_batch >= {spec_k + 1} (the "
                    f"verify window rides the decode batch rows), got "
                    f"max_batch={max_batch}")
            if fp8_kv:
                raise ValueError("spec_k > 0 does not compose with fp8_kv "
                                 "(per-page slot-0 scales need sequential "
                                 "writes)")
            if draft_params is None:
                layers = draft_num_layers or max(1, cfg.num_layers // 2)
                self.draft_cfg, self.draft_params = spec_mod.derive_draft(
                    cfg, self.params, num_layers=layers)
            else:
                if draft_cfg is None:
                    raise ValueError("draft_params requires draft_cfg")
                _check_params(draft_params, self.device)
                self.draft_cfg = draft_cfg
                if fp8_weights:
                    with torch.no_grad():
                        draft_params = model_mod.quantize_gpt_weights(
                            draft_cfg, draft_params, margin=fp8_weight_margin)
                self.draft_params = draft_params
            # the draft pool mirrors the target pool's geometry (num_pages,
            # page_size), so the draft reuses each sequence's block table
            self.draft_ccfg = cache_mod.CacheConfig(
                num_layers=self.draft_cfg.num_layers,
                kv_heads=self.draft_cfg.num_heads,
                head_dim=self.draft_cfg.head_dim, num_pages=num_pages,
                page_size=psize, dtype=self.draft_cfg.dtype)
            self.draft_state = cache_mod.init_cache(self.draft_ccfg,
                                                    device=self.device)
        self.state = cache_mod.init_cache(self.ccfg, device=self.device)
        self.sched = Scheduler(num_pages=num_pages, page_size=psize,
                               max_batch=max_batch, lookahead=self.spec_k)
        self.max_batch = max_batch
        self.slots: List[Optional[Sequence]] = [None] * max_batch
        self.record_logits = record_logits
        self.logits_log: Dict[int, Dict[int, np.ndarray]] = {}
        # host-clock seconds of each batched decode step or verify call
        # (synchronised by the token read-back), its number of live rows,
        # and of each prefill with its prompt length
        self.decode_step_times: List[float] = []
        self.decode_step_sizes: List[int] = []
        self.prefill_times: List[Tuple[int, float]] = []
        # speculative rounds: draft-decode calls, tokens drafted, accepted
        self.spec_rounds = 0
        self.draft_calls = 0
        self.draft_tokens = 0
        self.accepted_tokens = 0
        self.tokens_generated = 0
        self._next_id = 0
        self.seqs: Dict[int, Sequence] = {}    # every request ever added

    # -- device steps ------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _decode(self, bts, pos, tok, act):
        logits, _ = model_mod.decode_forward(
            self.cfg, self.ccfg, self.params, self.state, self._tensor(bts),
            self._tensor(pos).long(), self._tensor(tok).long(),
            self._tensor(act))
        return logits, logits.argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def _draft_decode(self, bts, pos, tok, act) -> np.ndarray:
        """The decode step of the draft over its own pool; only the
        argmaxes leave the device."""
        logits, _ = model_mod.decode_forward(
            self.draft_cfg, self.draft_ccfg, self.draft_params,
            self.draft_state, self._tensor(bts), self._tensor(pos).long(),
            self._tensor(tok).long(), self._tensor(act))
        self.draft_calls += 1
        return logits.argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, bt, length, ids):
        logits, _ = model_mod.prefill_forward(
            self.cfg, self.ccfg, self.params, self.state, self._tensor(bt),
            length, self._tensor(ids).long())
        return logits, int(logits.argmax())

    # -- request intake ----------------------------------------------

    def add_request(self, prompt: List[int], max_new_tokens: int) -> int:
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        seq = Sequence(seq_id=self._next_id, prompt=list(prompt),
                       max_new_tokens=max_new_tokens)
        self._next_id += 1
        self.seqs[seq.seq_id] = seq
        self.sched.add(seq)
        return seq.seq_id

    # -- host-side step driving --------------------------------------

    def _bt_row(self, seq: Sequence) -> np.ndarray:
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:len(seq.pages)] = seq.pages
        return row

    def _blank_batch(self):
        return (np.zeros((self.max_batch,), np.int32),
                np.zeros((self.max_batch,), np.int32),
                np.zeros((self.max_batch,), bool),
                np.zeros((self.max_batch, self.pages_per_seq), np.int32))

    def _record(self, seq: Sequence, pos: int, logits_row) -> None:
        if self.record_logits:
            self.logits_log.setdefault(seq.seq_id, {})[pos] = \
                logits_row.cpu().numpy()

    def _free_slot(self, seq: Sequence) -> None:
        for i, s in enumerate(self.slots):
            if s is seq:
                self.slots[i] = None

    def _sample(self, seq: Sequence, token: int) -> None:
        seq.tokens.append(int(token))
        self.tokens_generated += 1
        if seq.done:
            self.sched.finish(seq)
            self._free_slot(seq)

    def _replay_generated(self, seq: Sequence) -> None:
        """Recompute the cache for a resumed sequence's generated tokens
        through the decode step (single-slot-active batches): the same
        rows as the original steps, hence bit-exact. The last token is NOT
        replayed — it is the next decode's input."""
        slot = self.slots.index(seq)
        for j in range(len(seq.prompt), seq.num_tokens - 1):
            tok, pos, act, bts = self._blank_batch()
            tok[slot] = seq.tokens[j]
            pos[slot] = j
            act[slot] = True
            bts[slot] = self._bt_row(seq)
            logits, _ = self._decode(bts, pos, tok, act)
            self._record(seq, j + 1, logits[slot])
            seq.num_cached = j + 1

    # -- speculative decoding ----------------------------------------

    def _draft_propose(self, seq: Sequence, bt: np.ndarray,
                       k: int) -> List[int]:
        """Draft ``k`` tokens for one sequence. First ingests the committed
        positions ``draft_cached..n-1`` through the draft decode step, up to
        ``max_batch`` consecutive positions of this one sequence per call
        (legal for the reason verify is: writes land before reads, per-row
        ``seq_lens`` mask causality); this rebuilds the draft cache over a
        rejected round's garbage and, from the feed of ``tokens[n-1]``,
        gives the first proposal. Then ``k-1`` single-row calls extend it."""
        n = seq.num_tokens
        d1 = None
        for lo in range(seq.draft_cached, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            tok, pos, act, bts = self._blank_batch()
            cnt = hi - lo
            tok[:cnt] = seq.tokens[lo:hi]
            pos[:cnt] = np.arange(lo, hi, dtype=np.int32)
            act[:cnt] = True
            bts[:cnt] = bt
            nxt = self._draft_decode(bts, pos, tok, act)
            if hi == n:
                d1 = int(nxt[cnt - 1])
        seq.draft_cached = n
        draft = [d1]
        for j in range(1, k):
            tok, pos, act, bts = self._blank_batch()
            tok[0] = draft[-1]
            pos[0] = n - 1 + j
            act[0] = True
            bts[0] = bt
            draft.append(int(self._draft_decode(bts, pos, tok, act)[0]))
        return draft

    def _spec_round(self, seq: Sequence) -> None:
        """One speculative round for one sequence: draft ``k`` tokens,
        verify all ``k+1`` positions in one decode call (rows ``0..k`` =
        positions ``n-1..n-1+k``; row 0 feeds the last committed token, rows
        1..k the draft), then commit the longest accepted prefix plus the
        verifier's bonus token (:func:`~apex_tpu_torch.serve.spec.
        accept_greedy`). A rejected suffix's K/V, in both pools, is
        overwritten by the next round's window before any row attends to
        it (rows read only positions up to their own)."""
        n = seq.num_tokens
        remaining = seq.max_new_tokens - seq.num_generated
        k = min(self.spec_k, remaining - 1)
        bt = self._bt_row(seq)
        draft: List[int] = self._draft_propose(seq, bt, k) if k > 0 else []
        tok, pos, act, bts = self._blank_batch()
        tok[0] = seq.tokens[-1]
        tok[1:k + 1] = draft
        pos[:k + 1] = (n - 1) + np.arange(k + 1, dtype=np.int32)
        act[:k + 1] = True
        bts[:k + 1] = bt
        t0 = time.perf_counter()
        logits, next_np = self._decode(bts, pos, tok, act)
        self.decode_step_times.append(time.perf_counter() - t0)
        self.decode_step_sizes.append(k + 1)
        committed, m = spec_mod.accept_greedy(
            draft, [int(t) for t in next_np[:k + 1]])
        # the target cache is valid through position n-1+m, the draft cache
        # through n-1+min(m, k-1): position n-1+j holds d_j's K/V, and d_k
        # was never fed to the draft
        seq.num_cached = n + m
        if k > 0:
            seq.draft_cached = n + min(m, k - 1)
        self.spec_rounds += 1
        self.draft_tokens += k
        self.accepted_tokens += m
        for i, t in enumerate(committed):
            self._record(seq, n + i, logits[i])
            self._sample(seq, t)

    def _do_prefill(self, seq: Sequence) -> None:
        slot = self.slots.index(None)
        self.slots[slot] = seq
        seq.slot = slot
        resumed = seq.num_generated > 0
        ids = np.zeros((self.max_prompt_len,), np.int32)
        ids[:len(seq.prompt)] = seq.prompt
        t0 = time.perf_counter()
        logits, next_tok = self._prefill(self._bt_row(seq), len(seq.prompt),
                                         ids)
        self.prefill_times.append((len(seq.prompt),
                                   time.perf_counter() - t0))
        seq.num_cached = len(seq.prompt)
        self._record(seq, len(seq.prompt), logits)
        if not resumed:
            self._sample(seq, next_tok)
        else:
            # resumed: the generated tokens already exist; rebuild the
            # cache deterministically instead of re-sampling
            self._replay_generated(seq)

    def step(self) -> bool:
        """One scheduler round: prefills + one batched decode. Returns
        whether any work remains."""
        plan = self.sched.schedule()
        for seq in plan.preempted:
            self._free_slot(seq)
        for seq in plan.prefill:
            self._do_prefill(seq)
        decodes = [s for s in plan.decode
                   if not s.done and s.state == RUNNING]
        if decodes and self.spec_k:
            # one draft + verify round per sequence (the verify window owns
            # the batch rows)
            for seq in decodes:
                if not seq.done and seq.state == RUNNING:
                    self._spec_round(seq)
        elif decodes:
            tok, pos, act, bts = self._blank_batch()
            for seq in decodes:
                slot = seq.slot
                tok[slot] = seq.tokens[-1]
                pos[slot] = seq.num_tokens - 1
                act[slot] = True
                bts[slot] = self._bt_row(seq)
            t0 = time.perf_counter()
            logits, next_np = self._decode(bts, pos, tok, act)
            self.decode_step_times.append(time.perf_counter() - t0)
            self.decode_step_sizes.append(len(decodes))
            for seq in decodes:
                slot = seq.slot
                seq.num_cached = seq.num_tokens
                self._record(seq, seq.num_tokens, logits[slot])
                self._sample(seq, next_np[slot])
        return self.sched.has_work

    def preempt(self, seq_id: int) -> None:
        """Force-preempt a running sequence (tests/benchmarks; the organic
        path is the scheduler's evict-on-exhaustion)."""
        for seq in self.sched.running:
            if seq.seq_id == seq_id:
                self.sched.preempt(seq)
                self._free_slot(seq)
                return
        raise KeyError(f"sequence {seq_id} is not running")

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive until every request finished; returns seq_id -> generated
        tokens for EVERY request ever added."""
        steps = 0
        while self.sched.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serve engine did not drain in "
                                   f"{max_steps} steps")
        return {sid: s.tokens[len(s.prompt):]
                for sid, s in self.seqs.items()}

    def serve(self, **_):
        raise NotImplementedError("the live metrics surface (serve "
                                  "telemetry) is not ported yet; use run()")


@torch.no_grad()
def naive_generate(cfg: GPTConfig, params: GPT, requests, *,
                   max_seq_len: int, device: DeviceLike = None):
    """The full-recompute baseline: the same batched greedy decoding with
    NO KV cache — every token recomputes the whole prefix (one fixed-shape
    forward over the padded context per step).

    ``requests``: list of ``(prompt, max_new_tokens)``. Returns
    ``(outputs: list[list[int]], step_times: list[float])``.
    """
    dev = resolve_device(device)
    _check_params(params, dev)
    B = len(requests)
    ids = np.zeros((B, max_seq_len), np.int64)
    lengths = np.zeros((B,), np.int64)
    todo = np.zeros((B,), np.int64)
    for i, (prompt, n_new) in enumerate(requests):
        ids[i, :len(prompt)] = prompt
        lengths[i] = len(prompt)
        todo[i] = n_new
    outputs: List[List[int]] = [[] for _ in range(B)]
    step_times: List[float] = []
    while (np.array([len(o) for o in outputs]) < todo).any():
        t0 = time.perf_counter()
        logits = model_mod.full_forward_logits(
            cfg, params, torch.from_numpy(ids).to(dev),
            torch.from_numpy(lengths).to(dev))
        next_toks = logits.argmax(dim=-1).cpu().numpy()
        step_times.append(time.perf_counter() - t0)
        for i in range(B):
            if len(outputs[i]) < todo[i]:
                outputs[i].append(int(next_toks[i]))
                ids[i, lengths[i]] = next_toks[i]
                lengths[i] += 1
    return outputs, step_times
