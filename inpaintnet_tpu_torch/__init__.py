"""inpaintnet_tpu_torch — the PyTorch and CUDA port of ``inpaintnet_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax`` nor anything of
``inpaintnet_tpu``:

- ``ops``    — GRU and LSTM loops and the training GRU layer (an autograd
  Function), linear/embedding primitives, the diagonal normal and its KL,
  argmax and categorical sampling, and the hand-written CUDA kernels
  (``ops/csrc``) with their wrappers and plain versions
  (``encoder_kernel``, ``decode_kernel``, ``gru_train_kernel``,
  ``arnn_kernel``).
- ``models`` — MeasureVAE (inference and training), the
  non-autoregressive LatentRNN, the AnticipationRNN family (inference),
  parameter conversion and checkpoints in the JAX package's layout,
  presets.
- ``serve``  — the batched inpainting engine; ``serve_arnn`` the
  AnticipationRNN's; ``server`` the HTTP front end of both.
- ``train``  — the single-device trainer and the MeasureVAE, LatentRNN
  and AnticipationRNN trainers.
- ``eval``   — the MeasureVAE, LatentRNN and AnticipationRNN testers and
  the HTML report; ``data`` the corpus, tokenizer and datasets; ``utils``
  the live training plot.
- ``cli``    — the entry points, ``python -m inpaintnet_tpu_torch.cli.<name>``:
  twins of the JAX package's root scripts, on the card unless
  ``--device cpu``.
"""

__version__ = "0.1.0"
