"""Training (``inpaintnet_tpu/train``): the single-device trainer, the
MeasureVAE trainer, their losses, train-state checkpoints and an in-memory
dataset."""
