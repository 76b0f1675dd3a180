"""Models of the port (``apex_tpu.models``)."""

from apex_tpu_torch.models.gpt import GPT, GPTConfig

__all__ = ["GPT", "GPTConfig"]
