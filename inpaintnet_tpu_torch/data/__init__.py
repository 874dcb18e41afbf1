"""Data pieces the port needs, numpy only (copies of ``inpaintnet_tpu/data``
modules, which the port does not import)."""
