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
engine down to the kernels: there is no process-wide setting.
"""
from __future__ import annotations

import torch

QUANT_MODES = ("none", "int8")

# fixed scale of tanh-bounded recurrent states (|h| < 1)
H_SCALE = 127.0


def check_quant(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")


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
