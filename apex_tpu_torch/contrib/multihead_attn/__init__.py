"""``apex_tpu_torch.contrib.multihead_attn``: the fused multihead attention
modules (``apex_tpu/contrib/multihead_attn``).

:class:`SelfMultiheadAttn`, :class:`EncdecMultiheadAttn` and
:class:`MaskSoftmaxDropout`, ``[seq, batch, embed]`` like the reference
modules. Their ``impl="fast"`` attention is the port's flash attention:
key padding as segment ids, an additive ``attn_mask`` as the kernels'
bias, attention dropout inside the kernels (``_fused_prep``).
"""

from apex_tpu_torch.contrib.multihead_attn.encdec_multihead_attn import \
    EncdecMultiheadAttn  # noqa: F401
from apex_tpu_torch.contrib.multihead_attn.mask_softmax_dropout import (
    MaskSoftmaxDropout, fast_mask_softmax_dropout)  # noqa: F401
from apex_tpu_torch.contrib.multihead_attn.self_multihead_attn import \
    SelfMultiheadAttn  # noqa: F401
