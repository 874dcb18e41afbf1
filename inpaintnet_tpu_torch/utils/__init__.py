"""Utilities (``inpaintnet_tpu/utils``): the live training plot."""
