"""Shared utilities of the port: parameter-tree, dtype and flat-buffer
helpers."""

from apex_tpu_torch.utils.flat import (  # noqa: F401
    FlatBuffer,
    flatten_tensors,
    unflatten_tensors,
)
from apex_tpu_torch.utils.tree import (  # noqa: F401
    cast_floating,
    is_floating,
    path_names,
    split_like,
    tree_all_finite,
)
