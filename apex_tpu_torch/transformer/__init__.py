"""Transformer building blocks of the port (``apex_tpu.transformer``)."""
