"""MeasureVAE: bidirectional-GRU encoder and hierarchical beat/tick decoder
(``inpaintnet_tpu/models/measure_vae.py``), at inference and in training.

The modules hold their parameters under the reference's ``state_dict``
names and shapes (``convert.py``); the functional methods take the nested
(in, out) parameters that ``params()`` returns, like the JAX package's
``apply(params, ...)``, so a trainer differentiates through whatever
parameters it passes.

Training (``train=True``) takes other routes than inference: every GRU
without a mask runs the trainfast autograd Function (K5 and K6 on the
card), never the serving kernels K2-K4; the encoder runs K1's training
mode instead where ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas`` (read at call
time, as the JAX package reads it; the default ``"xla"`` keeps K5/K6) and
K1 takes the geometry, its backward the eager scan under the same dropout
mask (:meth:`Encoder.apply`); dropout acts between GRU layers,
its masks drawn from an explicit ``torch.Generator``; the decoder flips one
teacher-forcing coin per batch (p = 0.5). The teacher-forced decode folds
the 4 beats into the batch, (B * 4, 6, E + H) with per-beat ``h0``, where
the JAX package vmaps over them: the same function, with dropout masks of
the same distribution but other bits.

In training, ``HierarchicalDecoder.sampling = "multinomial"`` samples each
tick's token from the logits (``ops/sampling.sample_categorical``: Gumbel
noise from the generator, or injected by a test) where the default
``"argmax"`` takes the top one; the sampling decode feeds the sample back.

``SRDecoder`` and ``SRDecoderNoInput`` are the model library's flat
single-GRU decoders (``inpaintnet_tpu/models/measure_vae.py:518-627``):
the first autoregressive over tokens embedded beside a projection of z,
the second a GRU pass over z broadcast to every tick.

Quirk kept for parity: ReLU on the output logits, so logits are
non-negative and all-zero rows (ties broken to token 0) are common.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from inpaintnet_tpu_torch.models.base import CheckpointedModel
from inpaintnet_tpu_torch.models.convert import (
    flat_decoder_leaves,
    from_functional,
    measure_vae_leaves,
    to_functional,
)
from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling as decode_sampling_kernel
from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling_int8
from inpaintnet_tpu_torch.ops.distributions import DiagNormal
from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn, encoder_hn_int8
from inpaintnet_tpu_torch.ops.gru import (
    apply_dropout,
    dropout_keep,
    gru_apply,
    gru_gates,
    gru_init,
    gru_layer_apply,
    gru_stack_cell_apply,
)
from inpaintnet_tpu_torch.ops.kernel_common import (
    decode_quantizes,
    decode_supports_hidden,
    encoder_quantizes,
    encoder_supports_hidden,
    kernel_with_eager_grad,
)
from inpaintnet_tpu_torch.ops.linear import (
    embedding_apply,
    embedding_init,
    linear_apply,
    linear_init,
    mlp_selu_apply,
    mlp_selu_init,
)
from inpaintnet_tpu_torch.ops.quantize import check_quant
from inpaintnet_tpu_torch.ops.sampling import gumbel as gumbel_noise
from inpaintnet_tpu_torch.ops.sampling import sample_argmax, sample_categorical
from inpaintnet_tpu_torch.utils.profiling import count

NUM_BEATS_PER_MEASURE = 4
NUM_TICKS_PER_MEASURE = 24
TICKS_PER_BEAT = NUM_TICKS_PER_MEASURE // NUM_BEATS_PER_MEASURE


class GRUWeights(nn.Module):
    """Parameters of a (bi)GRU stack under ``torch.nn.GRU``'s names and
    shapes (``weight_ih_l{k}[_reverse]`` (3H, in), ...). A container only:
    the recurrence is ``ops.gru`` or a kernel, never cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False, device=None):
        super().__init__()
        num_dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else hidden_size * num_dirs
            for d in range(num_dirs):
                sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
                for name, shape in ((f"weight_ih{sfx}", (3 * hidden_size, in_dim)),
                                    (f"weight_hh{sfx}", (3 * hidden_size, hidden_size)),
                                    (f"bias_ih{sfx}", (3 * hidden_size,)),
                                    (f"bias_hh{sfx}", (3 * hidden_size,))):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape, device=device)))


def _linear(in_dim, out_dim, device, act):
    return nn.Sequential(nn.Linear(in_dim, out_dim, device=device), act)


def _mlp_selu(in_dim, hidden_dim, out_dim, device):
    return nn.Sequential(nn.Linear(in_dim, hidden_dim, device=device), nn.SELU(),
                         nn.Linear(hidden_dim, out_dim, device=device))


class Encoder(nn.Module):
    """q(z | measure): embedding -> 2-layer bi-GRU -> concat of all final
    hiddens -> Linear/SELU/Linear mean and log-std heads."""

    def __init__(self, note_embedding_dim: int, rnn_hidden_size: int, num_layers: int,
                 num_notes: int, z_dim: int, device=None, dropout: float = 0.0):
        super().__init__()
        self.note_embedding_dim = note_embedding_dim
        self.rnn_hidden_size = rnn_hidden_size
        self.num_layers = num_layers
        self.num_notes = num_notes
        self.z_dim = z_dim
        self.dropout = dropout
        hid_cat = rnn_hidden_size * 2 * num_layers
        self.note_embedding_layer = nn.Embedding(num_notes, note_embedding_dim, device=device)
        self.lstm = GRUWeights(note_embedding_dim, rnn_hidden_size, num_layers, True, device)
        self.linear_mean = _mlp_selu(hid_cat, 2 * rnn_hidden_size, z_dim, device)
        self.linear_log_std = _mlp_selu(hid_cat, 2 * rnn_hidden_size, z_dim, device)

    def __repr__(self):
        return (f"Encoder({self.note_embedding_dim},GRU,{self.num_layers},"
                f"{self.rnn_hidden_size},{self.dropout},True,{self.z_dim},)")

    def init_params(self, rng: np.random.Generator) -> dict:
        hid_cat = self.rnn_hidden_size * 2 * self.num_layers
        return {
            "embedding": embedding_init(rng, self.num_notes, self.note_embedding_dim),
            "gru": gru_init(rng, self.note_embedding_dim, self.rnn_hidden_size,
                            self.num_layers, True),
            "mean_head": mlp_selu_init(rng, hid_cat, 2 * self.rnn_hidden_size, self.z_dim),
            "log_std_head": mlp_selu_init(rng, hid_cat, 2 * self.rnn_hidden_size, self.z_dim),
        }

    def use_kernel(self, dtype=None) -> bool:
        """K1 and K3 take this geometry in masters of ``dtype`` (None: in
        either): 2 bidirectional layers (always bidirectional here) and a
        hidden width up to 512, and in bf16 up to 577 (one that is not whole
        64-unit blocks on zero units, ``kernel_common.encoder_supports_hidden``);
        f32 and int8 on f32 masters above 512 run the eager scan, as the JAX
        package's gate reads the masters' itemsize. K3 runs only where the
        JAX package also quantizes (:meth:`apply`)."""
        return self.num_layers == 2 and encoder_supports_hidden(self.rnn_hidden_size, dtype)

    def quantizes(self, dtype) -> bool:
        """Whether ``quant="int8"`` runs K3 in masters of ``dtype``: where
        K3 takes the geometry (:meth:`use_kernel`) and the JAX package
        quantizes (``kernel_common.encoder_quantizes``, its kernel gate's
        bytes); elsewhere int8 computes what ``quant="none"`` does."""
        return self.use_kernel(dtype) and encoder_quantizes(self.rnn_hidden_size, dtype)

    def apply(self, params, tokens: torch.Tensor, quant: str = "none", *, train: bool = False,
              generator: Optional[torch.Generator] = None,
              dropout_masks=None) -> DiagNormal:
        """:param tokens: (B, 24) int tokens -> DiagNormal over z.
        :param quant: "int8" runs K3 where K3 takes the geometry and the
            JAX package quantizes (``kernel_common.encoder_quantizes``: its
            kernel gate's bytes, 18 H^2 x the masters' itemsize < 10e6);
            elsewhere it computes what "none" computes, K1 where K1 takes
            the geometry and the plain scan in the parameter dtype beyond,
            as the JAX package does when its kernel gate is closed
        :param train: the training route: the trainfast GRU layers with
            dropout between them (``generator`` draws the keep mask, or
            ``dropout_masks`` gives it), never K3; K1's training mode under
            ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas`` (:meth:`use_train_kernel`)

        Counts the measures it encodes as ``encoder.rows``
        (``utils.profiling``), on every route."""
        check_quant(quant)
        count("encoder.rows", tokens.shape[0])
        if train and self.use_train_kernel(params["gru"][0][0]["w_hh"].dtype):
            return self._apply_train_kernel(params, tokens, generator, dropout_masks)
        if train:
            emb = embedding_apply(params["embedding"], tokens)
            _, h_n = gru_apply(params["gru"], emb, last_outputs=False, dropout=self.dropout,
                               train=True, dropout_masks=dropout_masks, generator=generator)
        elif self.use_kernel(params["gru"][0][0]["w_hh"].dtype):
            # the kernel's forward; under a gradient, the eager scan's
            # backward at the same inputs (JAX's kernel_with_xla_grad)
            int8 = quant == "int8" and self.quantizes(params["gru"][0][0]["w_hh"].dtype)
            kernel = kernel_with_eager_grad(encoder_hn_int8 if int8 else encoder_hn,
                                            _encoder_eager_hn)
            h_n = kernel(params["gru"], params["embedding"]["table"], tokens)
        else:
            emb = embedding_apply(params["embedding"], tokens)
            _, h_n = gru_apply(params["gru"], emb, last_outputs=False)
        return self._heads(params, h_n, tokens.shape[0])

    def use_train_kernel(self, dtype=None) -> bool:
        """K1's training mode (the JAX package's opt-in
        ``_apply_train_pallas``): ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``, read
        at each call, and a geometry K1 takes in masters of ``dtype``
        (:meth:`use_kernel`; K1's own gate: the JAX package also asks that
        its weights fit the TPU's 10 MB VMEM budget, which only bf16 at H 512
        does). On the CPU the wrapper runs K1's plain version."""
        return (os.environ.get("INPAINTNET_TRAIN_ENCODER_IMPL", "xla") == "pallas"
                and self.use_kernel(dtype))

    def _apply_train_kernel(self, params, tokens: torch.Tensor, generator, dropout_masks):
        """The training forward through K1's training mode: the inter-layer
        keep mask is the very draw ``gru_apply``'s layer-0 dropout makes
        from ``generator`` (or ``dropout_masks[0]``), so both routes drop the
        same elements; the kernel runs the forward and the backward re-runs
        the eager scan under that mask (``kernel_with_eager_grad``)."""
        rate = self.dropout
        batch, seq_len = tokens.shape
        keep = None
        if rate > 0.0:
            keep = (dropout_masks[0] if dropout_masks is not None else dropout_keep(
                (batch, seq_len, 2 * self.rnn_hidden_size), rate, generator, tokens.device))
        kernel = kernel_with_eager_grad(
            lambda gp, tab, tok, kp: encoder_hn(gp, tab, tok, keep=kp, rate=rate),
            lambda gp, tab, tok, kp: _encoder_eager_hn(gp, tab, tok, kp, rate))
        h_n = kernel(params["gru"], params["embedding"]["table"], tokens, keep)
        return self._heads(params, h_n, batch)

    def _heads(self, params, h_n: torch.Tensor, batch: int) -> DiagNormal:
        """(L*D, B, H) torch-layout final hiddens -> (B, L*D*H) -> heads."""
        hidden = h_n.transpose(0, 1).reshape(batch, -1)
        z_mean = mlp_selu_apply(params["mean_head"], hidden)
        z_log_std = mlp_selu_apply(params["log_std_head"], hidden)
        return DiagNormal(z_mean, torch.exp(z_log_std))


def _encoder_eager_hn(gru, table: torch.Tensor, tokens: torch.Tensor, keep=None,
                      rate: float = 0.0) -> torch.Tensor:
    """K1's and K3's eager twin: h_n of the eager GRU scan over the
    embedded tokens (the JAX package's ``gru_apply`` twin, whatever the
    inference GRU route). With ``keep``, K1's training mode's: the eager
    loop of each layer (never the trainfast Function, so K5/K6 do not
    launch), layer 0's outputs dropped by ``keep`` at ``rate`` between the
    two layers."""
    emb = embedding_apply({"table": table}, tokens)
    if keep is None:
        return gru_apply(gru, emb, last_outputs=False, impl="xla")[1]
    x, h_n = emb, []
    for layer, dirs in enumerate(gru):
        outs = []
        for d, p in enumerate(dirs):
            h0 = x.new_zeros((x.shape[0], p["w_hh"].shape[0]))
            o, h = gru_layer_apply(p, x, h0, reverse=d == 1, want_ys=layer == 0, impl="xla")
            outs.append(o)
            h_n.append(h)
        if layer == 0:
            x = apply_dropout(torch.cat(outs, dim=-1), keep, rate)
    return torch.stack(h_n, dim=0)


class HierarchicalDecoder(nn.Module):
    """p(measure | z): z -> 4-step beat GRU -> per beat, a 6-tick GRU."""

    teacher_forcing_prob = 0.5  # one coin per training batch (decoder.py:374-376)

    def __init__(self, note_embedding_dim: int, num_notes: int, z_dim: int,
                 num_layers: int, rnn_hidden_size: int, device=None, dropout: float = 0.0):
        super().__init__()
        self.note_embedding_dim = note_embedding_dim
        self.num_notes = num_notes
        self.z_dim = z_dim
        self.num_layers = num_layers
        self.rnn_hidden_size = rnn_hidden_size
        self.dropout = dropout
        H, L, E = rnn_hidden_size, num_layers, note_embedding_dim
        self.note_embedding_layer = nn.Embedding(num_notes, E, device=device)
        self.z_to_beat_rnn_input = _linear(z_dim, H * L, device, nn.SELU())
        self.b_0 = nn.Parameter(torch.empty((1,), device=device))
        self.rnn_beat = GRUWeights(1, H, L, False, device)
        self.beat_emb_to_tick_rnn_hidden = _linear(H, H * L, device, nn.SELU())
        self.beat_emb_to_tick_rnn_input = _linear(H, H, device, nn.SELU())
        self.x_0 = nn.Parameter(torch.empty((E,), device=device))
        self.rnn_tick = GRUWeights(E + H, H, L, False, device)
        self.tick_emb_to_note_emb = _linear(H, num_notes, device, nn.ReLU())
        self.sampling = "argmax"  # or "multinomial" (training only)

    def __repr__(self):
        return (f"HierarchicalDecoder{self.note_embedding_dim},GRU,{self.num_layers},"
                f"{self.rnn_hidden_size},{self.dropout},)")

    def init_params(self, rng: np.random.Generator) -> dict:
        H, L, E = self.rnn_hidden_size, self.num_layers, self.note_embedding_dim
        return {
            "embedding": embedding_init(rng, self.num_notes, E),
            "z_to_beat_hidden": linear_init(rng, self.z_dim, H * L),
            "b_0": np.zeros((1,), np.float32),
            "beat_gru": gru_init(rng, 1, H, L),
            "beat_to_tick_hidden": linear_init(rng, H, H * L),
            "beat_to_tick_input": linear_init(rng, H, H),
            "x_0": np.zeros((E,), np.float32),
            "tick_gru": gru_init(rng, E + H, H, L),
            "head": linear_init(rng, H, self.num_notes),
        }

    def _beat_outputs(self, params, z: torch.Tensor, *, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z -> beat-GRU outputs (B, 4, H); in training with dropout between
        the beat GRU's layers."""
        batch = z.shape[0]
        h0 = torch.selu(linear_apply(params["z_to_beat_hidden"], z))
        h0 = h0.reshape(batch, self.num_layers, -1).transpose(0, 1)
        beat_in = params["b_0"].expand(batch, NUM_BEATS_PER_MEASURE, 1)
        beat_out, _ = gru_apply(params["beat_gru"], beat_in, h0.contiguous(),
                                dropout=self.dropout, train=train, generator=generator)
        return beat_out

    def _tick_h0(self, params, beat_vec: torch.Tensor) -> torch.Tensor:
        """Per-beat tick-GRU init hidden: (N, H) -> (L, N, H)."""
        h0 = torch.selu(linear_apply(params["beat_to_tick_hidden"], beat_vec))
        return h0.reshape(beat_vec.shape[0], self.num_layers, -1).transpose(0, 1)

    def _logits(self, params, tick_out: torch.Tensor) -> torch.Tensor:
        # ReLU on logits: the reference's quirk, kept
        return torch.relu(linear_apply(params["head"], tick_out))

    def use_kernel(self, dtype=None) -> bool:
        """K2 and K4 take this geometry in masters of ``dtype`` (None: in
        either): 2 tick-GRU layers (the decode here is always argmax
        inference) and a hidden width up to 512, and in bf16 up to 717 (one
        no plan takes on zero units at the next one that does,
        ``kernel_common.decode_supports_hidden``); f32 and int8 on f32
        masters above 512 run the eager loop. K4 runs only where the JAX
        package also quantizes (:meth:`decode_sampling`)."""
        return self.num_layers == 2 and decode_supports_hidden(self.rnn_hidden_size, dtype)

    def quantizes(self, dtype) -> bool:
        """Whether ``quant="int8"`` runs K4 in masters of ``dtype``: where
        K4 takes the geometry (:meth:`use_kernel`) and the JAX package
        quantizes (``kernel_common.decode_quantizes``, its kernel gate's
        bytes at this vocabulary); elsewhere int8 computes what
        ``quant="none"`` does."""
        return self.use_kernel(dtype) and decode_quantizes(self.rnn_hidden_size, self.num_notes,
                                                           dtype)

    def decode_teacher_forced(self, params, z: torch.Tensor, tokens: torch.Tensor, *,
                              train: bool = True, generator: Optional[torch.Generator] = None,
                              gumbel: Optional[torch.Tensor] = None):
        """All 4 beats decoded at once on ground-truth inputs: the beats
        fold into the batch, (B * 4, 6, E + H), each with its own ``h0``.

        :param tokens: (B, 24) int ground truth
        :param gumbel: optional (B, 24, V) noise of the multinomial samples
        :return: (logits (B, 24, V), samples (B, 24))
        """
        batch = z.shape[0]
        H = self.rnn_hidden_size
        beat_out = self._beat_outputs(params, z, train=train, generator=generator)
        emb = embedding_apply(params["embedding"], tokens)  # (B, 24, E)
        x0 = params["x_0"].expand(batch, 1, emb.shape[-1])
        emb_in = torch.cat([x0, emb[:, :-1]], dim=1)  # inputs shifted by one tick
        tick_ctx = torch.selu(linear_apply(params["beat_to_tick_input"], beat_out))  # (B, 4, H)
        xs = torch.cat([
            emb_in.reshape(batch, NUM_BEATS_PER_MEASURE, TICKS_PER_BEAT, -1),
            tick_ctx[:, :, None].expand(batch, NUM_BEATS_PER_MEASURE, TICKS_PER_BEAT, H),
        ], dim=-1).reshape(batch * NUM_BEATS_PER_MEASURE, TICKS_PER_BEAT, -1)
        h0s = self._tick_h0(params, beat_out.reshape(batch * NUM_BEATS_PER_MEASURE, -1))
        tick_out, _ = gru_apply(params["tick_gru"], xs, h0s, dropout=self.dropout,
                                train=train, generator=generator)
        logits = self._logits(params, tick_out).reshape(batch, NUM_TICKS_PER_MEASURE, -1)
        return logits, _sample(self.sampling, logits, train, gumbel, generator)

    def decode_sampling(self, params, z: torch.Tensor, quant: str = "none", *,
                        train: bool = False, generator: Optional[torch.Generator] = None,
                        gumbel: Optional[torch.Tensor] = None):
        """Decode of one measure per latent, each tick's token fed back:
        the argmax, or in training under ``sampling = "multinomial"`` a
        categorical draw.

        :param quant: "int8" runs K4 where K4 takes the geometry and the
            JAX package quantizes (``kernel_common.decode_quantizes``: (9 H^2
            + 4 H Vp) x the masters' itemsize < 10e6, Vp the vocabulary
            padded to 128); elsewhere it computes what "none" computes, K2
            where K2 takes the geometry and the plain scan beyond
        :param train: the training route: dropout in the beat GRU and on
            the tick GRU's layer-0 output at every tick, through the eager
            loop (autograd differentiates it), never K2 or K4
        :param gumbel: optional (B, 24, V) noise of the multinomial samples
        :return: (logits (B, 24, V), samples (B, 24) int32)

        Counts the measures it decodes as ``decoder.rows``
        (``utils.profiling``), on every route.
        """
        check_quant(quant)
        batch = z.shape[0]
        count("decoder.rows", batch)
        beat_out = self._beat_outputs(params, z, train=train, generator=generator)
        tick_ctx = torch.selu(linear_apply(params["beat_to_tick_input"], beat_out))
        h_inits = self._tick_h0(
            params, beat_out.reshape(batch * NUM_BEATS_PER_MEASURE, -1)
        ).reshape(self.num_layers, batch, NUM_BEATS_PER_MEASURE, -1)
        dtype = params["tick_gru"][0][0]["w_hh"].dtype
        if not train and self.use_kernel(dtype):
            # the kernel's forward; under a gradient (LatentRNN training
            # differentiates through this frozen-VAE decode) the backward of
            # the unquantized eager scan at the same inputs, as JAX's
            # kernel_with_xla_grad, for K4 too
            int8 = quant == "int8" and self.quantizes(dtype)
            kernel = kernel_with_eager_grad(
                decode_sampling_int8 if int8 else decode_sampling_kernel,
                lambda p, c, h: self._decode_scan(p, c, h, train=False))
            return kernel(params, tick_ctx.contiguous(), h_inits.contiguous())
        return self._decode_scan(params, tick_ctx, h_inits, train=train, generator=generator,
                                 gumbel=gumbel)

    def _decode_scan(self, params, tick_ctx: torch.Tensor, h_inits: torch.Tensor, *,
                     train: bool = False, generator: Optional[torch.Generator] = None,
                     gumbel: Optional[torch.Tensor] = None):
        """The 24-tick decode as a plain loop in the parameters' dtype (the
        JAX package's XLA scan): layer 0's token and beat-context input
        projections are hoisted out of the loop. In training, a fresh keep
        mask drops the input of every layer above 0 at every tick."""
        batch = tick_ctx.shape[0]
        E = self.note_embedding_dim
        p0 = params["tick_gru"][0][0]
        token_xw = params["embedding"]["table"] @ p0["w_ih"][:E]  # (V, 3H)
        ctx_xw = tick_ctx @ p0["w_ih"][E:] + p0["b_ih"]  # (B, 4, 3H)
        prev_xw = (params["x_0"] @ p0["w_ih"][:E]).expand(batch, -1)
        logits, samples = [], []
        for t in range(NUM_TICKS_PER_MEASURE):
            beat = t // TICKS_PER_BEAT
            if t % TICKS_PER_BEAT == 0:
                h = list(h_inits[:, :, beat])
            xw = prev_xw + ctx_xw[:, beat]
            inp = None
            for layer in range(self.num_layers):
                p = params["tick_gru"][layer][0]
                if layer > 0:
                    xw = inp @ p["w_ih"] + p["b_ih"]
                h[layer] = gru_gates(p, h[layer], xw)
                inp = h[layer]
                if train and self.dropout > 0.0 and layer < self.num_layers - 1:
                    keep = dropout_keep(inp.shape, self.dropout, generator, inp.device)
                    inp = apply_dropout(inp, keep, self.dropout)
            lg = self._logits(params, inp)
            s = _sample(self.sampling, lg, train, None if gumbel is None else gumbel[:, t],
                        generator)
            prev_xw = token_xw[s]
            logits.append(lg)
            samples.append(s)
        return torch.stack(logits, dim=1), torch.stack(samples, dim=1).to(torch.int32)

    def apply(self, params, z: torch.Tensor, tokens: torch.Tensor, *, train: bool,
              coin: Optional[bool] = None, generator: Optional[torch.Generator] = None,
              coin_generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None):
        """The reference's forward: in training, one teacher-forcing coin
        for the whole batch (True: :meth:`decode_teacher_forced`, else
        :meth:`decode_sampling`), drawn on the host from ``coin_generator``
        (a CPU generator, so branching waits for no device) unless given;
        out of training, the argmax sampling decode."""
        if not train:
            return self.decode_sampling(params, z)
        coin = _flip(coin, coin_generator, self.teacher_forcing_prob)
        if coin:
            return self.decode_teacher_forced(params, z, tokens, train=True, generator=generator,
                                              gumbel=gumbel)
        return self.decode_sampling(params, z, train=True, generator=generator, gumbel=gumbel)


def _flip(coin: Optional[bool], coin_generator: Optional[torch.Generator], p: float) -> bool:
    """The per-batch teacher-forcing coin: ``coin`` if given, else a draw on
    the host from ``coin_generator``."""
    if coin is None:
        coin = bool(torch.rand((), generator=coin_generator) < p)
    return coin


def _sample(sampling: str, logits: torch.Tensor, train: bool, gumbel=None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A decoder's tokens of ``logits`` (..., V): ``sample_categorical``
    in training under ``sampling == "multinomial"`` (the noise ``gumbel``,
    or drawn from ``generator``), else the argmax."""
    if train and sampling == "multinomial":
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        return sample_categorical(logits, gumbel)
    return sample_argmax(logits)


class SRDecoder(nn.Module):
    """Flat single-GRU decoder (the JAX package's ``SRDecoder``, reference
    ``decoder.py:57-214``): z -> Linear/SELU/Linear -> an E-wide vector fed
    beside the previous token's embedding to a unidirectional GRU stack of
    24 ticks; ReLU'd logits. Training flips one teacher-forcing coin a batch:
    teacher forcing runs the whole sequence through ``gru_apply`` (the
    trainfast route where the width takes it), the sequential branch steps
    ``gru_stack_cell_apply`` with a fresh inter-layer mask a tick."""

    name = "SRDecoder"
    teacher_forcing_prob = 0.5
    no_input = False  # SRDecoderNoInput's z projection is one linear layer

    def __init__(self, note_embedding_dim: int, num_notes: int, z_dim: int, num_layers: int,
                 rnn_hidden_size: int, dropout: float, device=None):
        super().__init__()
        self.note_embedding_dim = note_embedding_dim
        self.num_notes = num_notes
        self.z_dim = z_dim
        self.num_layers = num_layers
        self.rnn_hidden_size = rnn_hidden_size
        self.dropout = dropout
        self.use_teacher_forcing = True
        self.sampling = "argmax"
        E, H = note_embedding_dim, rnn_hidden_size
        self.note_embedding_layer = nn.Embedding(num_notes, E, device=device)
        self.z_to_rnn_input = self._z_projection(device)
        self.x_0 = nn.Parameter(torch.empty((E,), device=device))
        self.rnn_dec = GRUWeights(self._rnn_input_size(), H, num_layers, False, device)
        self.rnn_out_to_note_emb = _linear(H, num_notes, device, nn.ReLU())

    def _z_projection(self, device) -> nn.Module:
        return _mlp_selu(self.z_dim, self.rnn_hidden_size, self.note_embedding_dim, device)

    def _z_projection_init(self, rng: np.random.Generator) -> dict:
        return mlp_selu_init(rng, self.z_dim, self.rnn_hidden_size, self.note_embedding_dim)

    def _rnn_input_size(self) -> int:
        return 2 * self.note_embedding_dim

    def __repr__(self):
        return (f"{self.name}{self.note_embedding_dim},GRU,{self.num_layers},"
                f"{self.rnn_hidden_size},{self.dropout},)")

    def init_params(self, rng: np.random.Generator) -> dict:
        E, H = self.note_embedding_dim, self.rnn_hidden_size
        return {
            "embedding": embedding_init(rng, self.num_notes, E),
            "z_to_rnn_input": self._z_projection_init(rng),
            "x_0": np.zeros((E,), np.float32),
            "gru": gru_init(rng, self._rnn_input_size(), H, self.num_layers),
            "head": linear_init(rng, H, self.num_notes),
        }

    def leaves(self):
        return flat_decoder_leaves(self.num_layers, self.no_input)

    def params(self) -> dict:
        return to_functional(self.state_dict(), self.leaves())

    def set_params(self, params) -> None:
        self.load_state_dict(from_functional(params, self.leaves()), strict=True)

    def _logits(self, params, out: torch.Tensor) -> torch.Tensor:
        return torch.relu(linear_apply(params["head"], out))

    def apply(self, params, z: torch.Tensor, tokens: torch.Tensor, *, train: bool,
              coin: Optional[bool] = None, generator: Optional[torch.Generator] = None,
              coin_generator: Optional[torch.Generator] = None, dropout_masks=None,
              gumbel: Optional[torch.Tensor] = None):
        """The decoder's forward over ``tokens.shape[1]`` ticks.

        :param tokens: (B, T) int ground truth (teacher forcing's inputs)
        :param coin: the teacher-forcing coin (else drawn from ``coin_generator``)
        :param dropout_masks: optional bool keep masks in place of draws from
            ``generator``: teacher forcing's, one (B, T, H) per non-last
            layer; the sequential branch's, (T, L - 1, B, H) (a tick's masks
            of every non-last layer)
        :param gumbel: optional (B, T, V) noise of the multinomial samples
        :return: (logits (B, T, V), samples (B, T))
        """
        z_emb = mlp_selu_apply(params["z_to_rnn_input"], z)  # (B, E)
        if train and self.use_teacher_forcing and _flip(coin, coin_generator,
                                                          self.teacher_forcing_prob):
            emb = embedding_apply(params["embedding"], tokens)
            x0 = params["x_0"].expand(z.shape[0], 1, emb.shape[-1])
            emb_in = torch.cat([x0, emb[:, :-1]], dim=1)
            xs = torch.cat([emb_in, z_emb[:, None].expand_as(emb_in)], dim=-1)
            out, _ = gru_apply(params["gru"], xs, dropout=self.dropout, train=True,
                               dropout_masks=dropout_masks, generator=generator)
            logits = self._logits(params, out)
            return logits, sample_argmax(logits)
        return self._sequential(params, z_emb, tokens.shape[1], train, generator,
                                dropout_masks, gumbel)

    def _sequential(self, params, z_emb: torch.Tensor, seq_len: int, train: bool, generator,
                    dropout_masks, gumbel):
        """Tick by tick, the sampled token's embedding fed back."""
        batch = z_emb.shape[0]
        h = z_emb.new_zeros((self.num_layers, batch, self.rnn_hidden_size))
        prev = params["x_0"].expand(batch, -1)
        logits, samples = [], []
        for t in range(seq_len):
            h, out = gru_stack_cell_apply(
                params["gru"], h, torch.cat([prev, z_emb], dim=-1), dropout=self.dropout,
                train=train, generator=generator,
                dropout_masks=None if dropout_masks is None else dropout_masks[t])
            lg = self._logits(params, out)
            s = _sample(self.sampling, lg, train, None if gumbel is None else gumbel[:, t],
                        generator)
            prev = embedding_apply(params["embedding"], s)
            logits.append(lg)
            samples.append(s)
        return torch.stack(logits, dim=1), torch.stack(samples, dim=1)


class SRDecoderNoInput(SRDecoder):
    """Non-autoregressive flat decoder (the JAX package's
    ``SRDecoderNoInput``, reference ``decoder.py:217-310``): a linear
    projection of z broadcast to all 24 ticks, one GRU pass, argmax tokens.
    No teacher-forcing coin: every call is the same pass."""

    name = "SRDecoderNoInput"
    no_input = True

    def _z_projection(self, device) -> nn.Module:
        return nn.Linear(self.z_dim, self.rnn_hidden_size, device=device)

    def _z_projection_init(self, rng: np.random.Generator) -> dict:
        return linear_init(rng, self.z_dim, self.rnn_hidden_size)

    def _rnn_input_size(self) -> int:
        return self.rnn_hidden_size

    def apply(self, params, z: torch.Tensor, tokens: Optional[torch.Tensor] = None, *,
              train: bool, coin: Optional[bool] = None,
              generator: Optional[torch.Generator] = None, coin_generator=None,
              dropout_masks=None, gumbel=None):
        """One GRU pass over z's projection at each of the 24 ticks (the
        tokens, coin and noise are not read). -> (logits (B, 24, V),
        samples (B, 24))"""
        z_in = linear_apply(params["z_to_rnn_input"], z)
        xs = z_in[:, None].expand(z.shape[0], NUM_TICKS_PER_MEASURE, z_in.shape[-1])
        out, _ = gru_apply(params["gru"], xs, dropout=self.dropout, train=train,
                           dropout_masks=dropout_masks, generator=generator)
        logits = self._logits(params, out)
        return logits, sample_argmax(logits)


class MeasureVAE(CheckpointedModel, nn.Module):
    """Encoder and decoder, their reparameterised forward, and checkpoints
    in the JAX package's ``.npz`` layout.

    Made on any device but ``meta``, it holds the random parameters that
    ``init_params(numpy.random.default_rng(seed))`` draws. It lives on the
    card unless ``device`` says otherwise."""

    def __init__(self, dataset, note_embedding_dim: int = 10, num_encoder_layers: int = 2,
                 encoder_hidden_size: int = 512, latent_space_dim: int = 256,
                 num_decoder_layers: int = 2, decoder_hidden_size: int = 512, device="cuda",
                 encoder_dropout_prob: float = 0.5, decoder_dropout_prob: float = 0.5,
                 checkpoint_dir: Optional[str] = None, seed: int = 0):
        nn.Module.__init__(self)
        CheckpointedModel.__init__(self, checkpoint_dir)
        self.dataset_repr = repr(dataset)
        self.num_notes = len(dataset.note2index_dicts[0])
        self.latent_space_dim = latent_space_dim
        self.encoder = Encoder(note_embedding_dim, encoder_hidden_size, num_encoder_layers,
                               self.num_notes, latent_space_dim, device, encoder_dropout_prob)
        self.decoder = HierarchicalDecoder(note_embedding_dim, self.num_notes,
                                           latent_space_dim, num_decoder_layers,
                                           decoder_hidden_size, device, decoder_dropout_prob)
        if str(device) != "meta":
            self.set_params(self.init_params(np.random.default_rng(seed)))

    def __repr__(self):
        return f"MeasureVAE({self.dataset_repr},{self.encoder!r},{self.decoder!r},)"

    def init_params(self, rng: np.random.Generator) -> dict:
        """Random parameters in the JAX package's layout, as numpy."""
        return {"encoder": self.encoder.init_params(rng),
                "decoder": self.decoder.init_params(rng)}

    def leaves(self):
        return measure_vae_leaves(self.encoder.num_layers, self.decoder.num_layers)

    def params(self) -> dict:
        """The nested (in, out) parameters the functional methods take."""
        return to_functional(self.state_dict(), self.leaves())

    def set_params(self, params) -> None:
        """Copy nested (in, out) parameters (tensors or numpy) into the
        module, strictly."""
        self.load_state_dict(from_functional(params, self.leaves()), strict=True)

    def apply(self, params, tokens: torch.Tensor, *, train: bool = True,
              generator: Optional[torch.Generator] = None,
              coin_generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None, coin: Optional[bool] = None,
              gumbel: Optional[torch.Tensor] = None):
        """The VAE forward (``measure_vae.py:687-706``).

        :param tokens: (B, 24) int tokens
        :param generator: draws dropout masks and the rsample noise
        :param coin_generator: CPU generator of the teacher-forcing coin
        :param eps: optional (B, z) rsample noise; :param coin: optional
            teacher-forcing coin (both let a test inject the JAX package's);
            :param gumbel: optional (B, 24, V) noise of the decoder's
            multinomial samples
        :return: (weights (B, 24, V), samples (B, 24), z_dist, prior_dist,
            z_tilde, z_prior)
        """
        if tokens.shape[1] != NUM_TICKS_PER_MEASURE:
            raise ValueError(f"tokens: {tokens.shape[1]} ticks, expected {NUM_TICKS_PER_MEASURE}")
        z_dist = self.encoder.apply(params["encoder"], tokens, train=train, generator=generator)
        z_tilde = z_dist.rsample(generator, eps)
        prior_dist = DiagNormal(torch.zeros_like(z_dist.loc), torch.ones_like(z_dist.scale))
        z_prior = prior_dist.sample(generator)
        weights, samples = self.decoder.apply(params["decoder"], z_tilde, tokens, train=train,
                                              coin=coin, generator=generator,
                                              coin_generator=coin_generator, gumbel=gumbel)
        return weights, samples, z_dist, prior_dist, z_tilde, z_prior

    def apply_test(self, params, measures: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None):
        """Reconstruction of several measures a row (``measure_vae.py:708-727``),
        batched over them: the encoder, an rsample, the argmax decode.

        :param measures: (B, M, 24) int tokens
        :param eps: optional (B * M, z) rsample noise in place of a draw
            from ``generator``
        :return: (weights (B, M, 24, V), samples (B, M, 24))
        """
        batch, num_measures, seq_len = measures.shape
        flat = measures.reshape(batch * num_measures, seq_len)
        z = self.encoder.apply(params["encoder"], flat).rsample(generator, eps)
        weights, samples = self.decoder.decode_sampling(params["decoder"], z)
        return (weights.reshape(batch, num_measures, seq_len, -1),
                samples.reshape(batch, num_measures, seq_len))
