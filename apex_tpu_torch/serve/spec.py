"""Speculative decoding of the port (``apex_tpu/serve/spec.py``): the
host-side half of the draft/verify loop the serve engine runs.

- A **draft model** — the same GPT truncated to its first ``num_layers``
  blocks (:func:`derive_draft`; the embedding, positions and final norm are
  shared, so no new weights exist) — proposes ``k`` tokens per round
  through its own paged cache.
- The **target verifies all k+1 positions in one call of the decode
  step**: rows ``0..k`` of the fixed-capacity batch carry positions
  ``n-1 .. n-1+k`` of one sequence. ``decode_forward`` writes every row's
  K/V before any row attends, and per-row ``seq_lens`` give the causal
  mask, so row ``i`` sees the committed prefix plus the draft rows
  ``< i``. The verify step is the paged-decode kernel with k+1 rows of one
  sequence: speculation has no kernel of its own.
- **Greedy acceptance** (:func:`accept_greedy`) commits the longest draft
  prefix matching the verifier's argmaxes plus the verifier's next token.
  No operation of the forward mixes batch rows, so a verify row is bitwise
  the plain-decode row at the same (token, position, cache), and greedy
  speculative output is token-identical to plain paged decode.

Everything here is host math; the engine owns the cache bookkeeping
(``Sequence.draft_cached``, the overwrite of rejected suffixes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence as Seq, Tuple

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.serve.model import ServeParams


def accept_greedy(draft_tokens: Seq[int],
                  verify_argmax: Seq[int]) -> Tuple[List[int], int]:
    """Greedy accept/reject for one speculative round.

    ``draft_tokens``: the ``k`` proposed tokens ``d_1..d_k``;
    ``verify_argmax``: the ``k+1`` verifier argmaxes ``a_0..a_k``, ``a_i``
    the target's greedy token after the committed prefix plus
    ``d_1..d_i``. Returns ``(committed, m)``: ``d_1..d_m`` plus the bonus
    token ``a_m``, where ``m`` is the longest prefix with
    ``d_i == a_{i-1}``. ``k = 0`` commits ``[a_0]``: plain decode.
    """
    k = len(draft_tokens)
    if len(verify_argmax) != k + 1:
        raise ValueError(f"need {k + 1} verifier argmaxes for {k} draft "
                         f"tokens, got {len(verify_argmax)}")
    m = 0
    while m < k and int(draft_tokens[m]) == int(verify_argmax[m]):
        m += 1
    committed = [int(t) for t in draft_tokens[:m]]
    committed.append(int(verify_argmax[m]))
    return committed, m


def derive_draft(cfg: GPTConfig, params, *,
                 num_layers: int) -> Tuple[GPTConfig, ServeParams]:
    """Depth-truncated draft: the target's first ``num_layers`` blocks with
    the shared embedding, positions and final norm. ``params`` is a
    :class:`~apex_tpu_torch.models.gpt.GPT` or a
    :class:`~apex_tpu_torch.serve.model.ServeParams` (fp8 weights); the
    draft holds the very same modules and tensors, copied or quantized
    anew nowhere."""
    if not (1 <= num_layers <= cfg.num_layers):
        raise ValueError(f"draft num_layers must be in [1, "
                         f"{cfg.num_layers}], got {num_layers}")
    draft_cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return draft_cfg, ServeParams(
        params.wte, params.wpe, params.ln_f,
        [params.block(i) for i in range(num_layers)])
