"""Testers of the port's models (``inpaintnet_tpu/eval``)."""
