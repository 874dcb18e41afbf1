"""int8 serving quantization for the int8 kernels K3 and K4
(``inpaintnet_tpu/ops/quantize.py``).

Scheme (symmetric, per output channel):
- weights: ``scale[col] = max|w[:, col]| / 127`` in f32, floored at 1e-12,
  ``q = clip(round(w / scale), -127, 127)`` with round-half-to-even; the
  int32 product is dequantized by ``scale`` in f32;
- hidden states: ``q_h = round(h * qscale)``, with ``qscale = 127`` for the
  encoder's tanh-bounded carry (|h| < 1) and ``127 / bound`` per row for
  the decoder's (``ops/decode_kernel.py``);
- gate math stays f32: only the products are quantized.

The mode is an explicit argument (``quant="none" | "int8"``) from the
engine down to the kernels, which read no process-wide setting.
:func:`serve_quant_mode` gives a caller the JAX package's ambient mode
(``INPAINTNET_SERVE_QUANT``, or a :func:`serving_quant` scope) to pass
there.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import torch

QUANT_MODES = ("none", "int8")

# fixed scale of tanh-bounded recurrent states (|h| < 1)
H_SCALE = 127.0


def check_quant(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")


_SERVE_QUANT: contextvars.ContextVar = contextvars.ContextVar("serve_quant", default=None)


def serve_quant_mode() -> str:
    """The ambient serving quantization, "int8" or "none": the innermost
    :func:`serving_quant` scope's, else ``INPAINTNET_SERVE_QUANT`` (default
    "none"), read at each call as the JAX package reads it. A value for an
    explicit ``quant=`` argument."""
    mode = _SERVE_QUANT.get()
    if mode is None:
        mode = os.environ.get("INPAINTNET_SERVE_QUANT", "none")
    check_quant(mode)
    return mode


@contextlib.contextmanager
def serving_quant(mode: Optional[str]):
    """Scope in which :func:`serve_quant_mode` is ``mode`` (None defers to
    the environment); scoped to the thread or task that enters it."""
    if mode is not None:
        check_quant(mode)
    token = _SERVE_QUANT.set(mode)
    try:
        yield
    finally:
        _SERVE_QUANT.reset(token)


def quantize_cols_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of a (K, N) matrix.

    :return: (q int8 (K, N), scale f32 (1, N)) with ``w ~= q * scale``
    """
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=0, keepdim=True) / 127.0, 1e-12)
    # a division, not a multiply by the reciprocal: the two round differently
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_h_int8(h: torch.Tensor, qscale=H_SCALE) -> torch.Tensor:
    """Quantize a bounded activation to int8 at ``qscale`` (= 127 / bound; a
    float, or an f32 tensor that broadcasts against ``h``)."""
    return torch.clamp(torch.round(h.float() * qscale), -127, 127).to(torch.int8)


def dequantize_h(q: torch.Tensor, qscale=H_SCALE) -> torch.Tensor:
    """Inverse of :func:`quantize_h_int8`, in f32: ``q * (1 / qscale)``."""
    return q.float() * (1.0 / qscale)
