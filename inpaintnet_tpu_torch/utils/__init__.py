"""Utilities (``inpaintnet_tpu/utils``): seeded generator streams
(``rng``), non-finite checks (``debug``), device timing (``timing``),
the engines' spans and counters and step timing (``profiling``) and the
live training plot (``plotting``)."""
from inpaintnet_tpu_torch.utils.rng import RngStream
