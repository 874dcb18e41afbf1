"""inpaintnet_tpu_torch — the PyTorch and CUDA port of ``inpaintnet_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax`` nor anything of
``inpaintnet_tpu``:

- ``ops``    — GRU and LSTM loops and the training GRU layer (an autograd
  Function), linear/embedding primitives, the diagonal normal and its KL,
  argmax and categorical sampling, int8 quantization, and the hand-written
  CUDA kernels (``ops/csrc``) with their wrappers and plain versions
  (``encoder_kernel``, ``decode_kernel``, ``gru_kernel``,
  ``gru_train_kernel``, ``arnn_kernel``).
- ``models`` — MeasureVAE and its flat decoders, LatentRNN (with its
  autoregressive mode and ablations), the AnticipationRNN family, parameter
  conversion and checkpoints in the JAX package's layout, presets.
- ``serve``  — the batched inpainting engine; ``serve_arnn`` the
  AnticipationRNN's; ``server`` the HTTP front end of both.
- ``train``  — the trainer base class, on one device or a (data, model)
  mesh, and the MeasureVAE, LatentRNN and AnticipationRNN trainers.
- ``parallel`` — the ("data", "model") mesh over local devices or a
  ``torch.distributed`` world, ``shard_params`` (gate matrices split over
  "model", gathered on use) and the multi-device dry run.
- ``eval``   — the MeasureVAE, LatentRNN and AnticipationRNN testers and
  the HTML report; ``data`` the corpus, tokenizer and datasets; ``utils``
  seeded generator streams, non-finite checks, timing, tracing and the
  live training plot.
- ``cli``    — the entry points, ``python -m inpaintnet_tpu_torch.cli.<name>``:
  twins of the JAX package's root scripts, on the card unless
  ``--device cpu``.
"""

__version__ = "0.1.0"
