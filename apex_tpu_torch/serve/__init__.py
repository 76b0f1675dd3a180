"""``apex_tpu_torch.serve`` — paged KV-cache GPT serving with continuous
batching, the port of ``apex_tpu.serve`` at tp=1 with a bf16 or fp32 cache.

- the **paged KV cache** (:mod:`~apex_tpu_torch.serve.cache`): one
  preallocated page pool + per-sequence block tables, updated in place;
- **paged decode attention** and **flash prefill attention**
  (``apex_tpu_torch.ops.flash_attention``) and the **LayerNorm** kernel
  (``apex_tpu_torch.ops.layer_norm``) — CUDA/Triton on the card, plain
  PyTorch on the CPU;
- the **continuous-batching scheduler** (:mod:`~apex_tpu_torch.serve.
  scheduler`): admit/evict/preempt at step granularity; preemption
  recomputes (prefill + decode-replay) and is bit-exact.

Quick start::

    params = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    engine = serve.ServeEngine(cfg, params, num_pages=64,
                               max_seq_len=256, max_prompt_len=64)
    engine.add_request(prompt_ids, max_new_tokens=32)
    outputs = engine.run()
"""

from apex_tpu_torch.serve.cache import (CacheConfig, CacheState, init_cache,
                                        resolve_page_size)
from apex_tpu_torch.serve.engine import ServeEngine, naive_generate
from apex_tpu_torch.serve.scheduler import (PageAllocator, Scheduler,
                                            Sequence, StepPlan)

__all__ = [
    "CacheConfig", "CacheState", "init_cache", "resolve_page_size",
    "ServeEngine", "naive_generate", "PageAllocator", "Scheduler",
    "Sequence", "StepPlan",
]
