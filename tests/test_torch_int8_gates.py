"""``quant="int8"`` quantizes exactly where the JAX package does.

The JAX package has int8 only inside its kernel branches, which byte
formulas of the TPU's VMEM gate (``Encoder._use_pallas``: 18 H^2 x
itemsize < 10e6; ``HierarchicalDecoder._use_pallas_decode``: (9 H^2 + 4 H
Vp) x itemsize < 10e6, Vp the vocabulary padded to 128); where they close,
its int8 serving computes in the masters' dtype. The port's kernel gates are
wider (K1 / K3 to H 577 in bf16, K2 / K4 to 717 and at any vocabulary), so
its int8 routes ask ``kernel_common.encoder_quantizes`` / ``decode_quantizes``
too. Both directions are held here:

- the gates, at every H in steps of 8 up to 1024, V in {30, 60, 128, 256,
  2000} and both masters' dtypes, JAX's read as on a TPU: the port
  quantizes (``Encoder.quantizes``, ``HierarchicalDecoder.quantizes``)
  exactly where JAX does;
- the routes on the CPU: at f32 H 376 (JAX's encoder gate at 10.18e6 bytes,
  its decode gate at V 1,000 closed; the port's kernel gates open)
  ``quant="int8"`` equals ``quant="none"`` bit for bit and calls no int8
  wrapper; at V 60 the decode still quantizes, as JAX's gate is open there.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.models import measure_vae as mv
from inpaintnet_tpu_torch.models.measure_vae import Encoder, HierarchicalDecoder
from inpaintnet_tpu_torch.ops import kernel_common as kc

from test_torch_hidden_widths import _one_torch_thread, on_tpu  # noqa: F401  (fixtures)
from test_torch_wide_widths import _port_models

GATE_WIDTHS = range(8, 1025, 8)
GATE_VOCABS = (30, 60, 128, 256, 2000)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_quantizes_exactly_where_jax_does(on_tpu, dtype):
    import jax.numpy as jnp

    from inpaintnet_tpu.models.measure_vae import Encoder as JaxEncoder
    from inpaintnet_tpu.models.measure_vae import HierarchicalDecoder as JaxHD

    w = jnp.zeros((1, 1), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    counts = {"encoder": [0, 0], "decode": [0, 0]}  # [JAX quantizes, it does not]
    for hidden in GATE_WIDTHS:
        jax_enc = SimpleNamespace(bidirectional=True, num_layers=2, rnn_hidden_size=hidden)
        jax_q = JaxEncoder._use_pallas(jax_enc, {"gru": [None, [{"w_hh": w}]]})
        assert Encoder(8, hidden, 2, 30, 12, device="meta").quantizes(dtype) == jax_q, \
            ("encoder", hidden, dtype)
        counts["encoder"][not jax_q] += 1
        for vocab in GATE_VOCABS:
            jax_dec = SimpleNamespace(num_layers=2, sampling="argmax", rnn_hidden_size=hidden,
                                      num_notes=vocab)
            jax_q = JaxHD._use_pallas_decode(jax_dec, {"tick_gru": [[{"w_hh": w}]]})
            port = HierarchicalDecoder(8, vocab, 12, 2, hidden, device="meta")
            assert port.quantizes(dtype) == jax_q, ("decode", hidden, vocab, dtype)
            counts["decode"][not jax_q] += 1
    # neither side of either gate is vacuous
    assert min(min(c) for c in counts.values()) >= 10, counts


def _recorded(monkeypatch):
    """The wrappers the models call, by name, in call order."""
    calls = []
    for name in ("encoder_hn", "encoder_hn_int8", "decode_sampling_kernel",
                 "decode_sampling_int8"):
        real = getattr(mv, name)
        monkeypatch.setattr(mv, name, lambda *a, name=name, real=real, **k:
                            calls.append(name) or real(*a, **k))
    return calls


def test_int8_is_the_unquantized_route_where_jax_does_not_quantize(monkeypatch, on_tpu):
    """f32 masters at H 376: JAX's encoder gate (18 H^2 x 4 = 10.18e6
    bytes) and its decode gate at V 1,000 (Vp 1,024) are closed, the port's
    K1 / K2 gates open: ``quant="int8"`` runs K1's and K2's plain versions
    and equals ``quant="none"`` bit for bit. At V 60 JAX's decode gate is
    open at H 376, and the port's decode quantizes too."""
    from inpaintnet_tpu.models.measure_vae import Encoder as JaxEncoder
    from inpaintnet_tpu.models.measure_vae import HierarchicalDecoder as JaxHD
    import jax.numpy as jnp

    hidden = 376
    w = jnp.zeros((1, 1), jnp.float32)
    jax_enc = SimpleNamespace(bidirectional=True, num_layers=2, rnn_hidden_size=hidden)
    assert not JaxEncoder._use_pallas(jax_enc, {"gru": [None, [{"w_hh": w}]]})
    calls = _recorded(monkeypatch)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 60, (3, 24)).astype(np.int32))
    enc, pe, _, _ = _port_models(hidden, hidden, torch.float32, vocab=60)
    assert enc.use_kernel(torch.float32) and not enc.quantizes(torch.float32)
    with torch.inference_mode():
        none, int8 = (enc.apply(pe, tokens, quant) for quant in ("none", "int8"))
    assert calls == ["encoder_hn", "encoder_hn"]
    assert torch.equal(none.loc, int8.loc) and torch.equal(none.scale, int8.scale)
    z = none.loc
    for vocab, quantizes in ((1000, False), (60, True)):
        jax_dec = SimpleNamespace(num_layers=2, sampling="argmax", rnn_hidden_size=hidden,
                                  num_notes=vocab)
        assert JaxHD._use_pallas_decode(jax_dec, {"tick_gru": [[{"w_hh": w}]]}) == quantizes
        _, _, dec, pd = _port_models(hidden, hidden, torch.float32, seed=vocab, vocab=vocab)
        assert dec.use_kernel(torch.float32) and dec.quantizes(torch.float32) == quantizes
        calls.clear()
        with torch.inference_mode():
            none, int8 = (dec.decode_sampling(pd, z, quant) for quant in ("none", "int8"))
        assert calls == ["decode_sampling_kernel",
                         "decode_sampling_int8" if quantizes else "decode_sampling_kernel"]
        if not quantizes:
            assert torch.equal(none[0], int8[0]) and torch.equal(none[1], int8[1])
    assert kc.decode_quantizes(hidden, 60, torch.float32)
    assert not kc.decode_quantizes(hidden, 1000, torch.float32)
