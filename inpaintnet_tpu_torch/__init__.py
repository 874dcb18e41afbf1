"""inpaintnet_tpu_torch — the PyTorch and CUDA port of ``inpaintnet_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax`` nor anything of
``inpaintnet_tpu``:

- ``ops``    — GRU loops and the training GRU layer (an autograd Function),
  linear/embedding primitives, the diagonal normal and its KL, argmax
  sampling, and the hand-written CUDA kernels (``ops/csrc``) with their
  wrappers and plain versions (``encoder_kernel``, ``decode_kernel``,
  ``gru_train_kernel``).
- ``models`` — MeasureVAE (inference and training) and the
  non-autoregressive LatentRNN, parameter conversion and checkpoints in
  the JAX package's layout, presets.
- ``serve``  — the batched inpainting engine; ``server`` its HTTP front end.
- ``train``  — the single-device trainer and the MeasureVAE trainer.
"""

__version__ = "0.1.0"
