"""Models of the port (``apex_tpu.models``)."""

from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.models.resnet import (BasicBlock, Bottleneck, ResNet,
                                          ResNet18, ResNet50, ResNet101)

__all__ = ["GPT", "GPTConfig", "ResNet", "ResNet18", "ResNet50", "ResNet101",
           "Bottleneck", "BasicBlock"]
