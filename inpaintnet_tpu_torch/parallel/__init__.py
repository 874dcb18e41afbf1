"""Data parallelism (``inpaintnet_tpu/parallel``): the ("data", "model")
mesh over local devices or a ``torch.distributed`` world."""
