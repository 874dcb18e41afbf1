"""inpaintnet_tpu_torch — the PyTorch and CUDA port of ``inpaintnet_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax``:

- ``ops``    — GRU loops, linear/embedding primitives, the diagonal normal,
  argmax sampling, and the hand-written CUDA kernels (``ops/csrc``) with
  their wrappers and plain versions (``encoder_kernel``, ``decode_kernel``).
- ``models`` — MeasureVAE and the non-autoregressive LatentRNN at
  inference, parameter conversion from the JAX package, presets.
- ``serve``  — the batched inpainting engine.
"""

__version__ = "0.1.0"
