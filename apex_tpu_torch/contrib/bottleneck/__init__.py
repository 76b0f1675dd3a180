"""apex_tpu_torch.contrib.bottleneck — the ResNet bottleneck and its
spatially parallel form (``apex_tpu/contrib/bottleneck``): ``Bottleneck``
is the port's ``models.resnet.Bottleneck``; ``SpatialBottleneck`` splits H
across the ranks of a process group, swapping halo rows around its 3x3
conv (:func:`halo_exchange`)."""

from apex_tpu_torch.contrib.bottleneck.bottleneck import (  # noqa: F401
    Bottleneck,
    SpatialBottleneck,
    halo_exchange,
)
