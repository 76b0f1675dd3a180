"""apex_tpu_torch.parallel — synchronized batch norm over
``torch.distributed`` (``apex_tpu/parallel``). DDP (``distributed.py``),
``overlap.py`` and ``multiproc.py`` are not ported yet (ROADMAP A9)."""

from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
)
