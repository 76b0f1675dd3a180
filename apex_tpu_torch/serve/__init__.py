"""``apex_tpu_torch.serve`` — paged KV-cache GPT serving with continuous
batching, the port of ``apex_tpu.serve`` at tp=1.

- the **paged KV cache** (:mod:`~apex_tpu_torch.serve.cache`): one
  preallocated page pool + per-sequence block tables, updated in place; in
  fp8-KV mode e4m3 pages with per-page scales (about twice the concurrent
  sequences at the same pool bytes);
- **paged decode attention** (bf16 or e4m3 pool) and **flash prefill
  attention** (``apex_tpu_torch.ops.flash_attention``), the **LayerNorm**
  kernel (``apex_tpu_torch.ops.layer_norm``) and, with fp8 weights, the
  **fp8 dequant-matmul** (``apex_tpu_torch.ops.fp8_matmul``) — CUDA/Triton
  on the card, plain PyTorch on the CPU;
- the **continuous-batching scheduler** (:mod:`~apex_tpu_torch.serve.
  scheduler`): admit/evict/preempt at step granularity; preemption
  recomputes (prefill + decode-replay) and is bit-exact;
- **speculative decoding** (:mod:`~apex_tpu_torch.serve.spec`): a
  depth-truncated draft proposes, the decode step verifies; greedy output
  is token-identical to plain decode.

Quick start::

    params = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    engine = serve.ServeEngine(cfg, params, num_pages=64,
                               max_seq_len=256, max_prompt_len=64,
                               fp8_weights=True, fp8_kv=True)
    engine.add_request(prompt_ids, max_new_tokens=32)
    outputs = engine.run()
"""

from apex_tpu_torch.serve.cache import (CacheConfig, CacheState, init_cache,
                                        resolve_page_size)
from apex_tpu_torch.serve.engine import ServeEngine, naive_generate
from apex_tpu_torch.serve.model import quantize_gpt_weights, weight_stream_bytes
from apex_tpu_torch.serve.scheduler import (PageAllocator, Scheduler,
                                            Sequence, StepPlan)
from apex_tpu_torch.serve.spec import accept_greedy, derive_draft

__all__ = [
    "CacheConfig", "CacheState", "init_cache", "resolve_page_size",
    "ServeEngine", "naive_generate", "PageAllocator", "Scheduler",
    "Sequence", "StepPlan", "accept_greedy", "derive_draft",
    "quantize_gpt_weights", "weight_stream_bytes",
]
