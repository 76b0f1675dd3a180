"""Contrib modules of the port (``apex_tpu.contrib``)."""
