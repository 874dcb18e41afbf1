"""LatentRNN (InpaintNet) over a frozen MeasureVAE, at inference and in
training, and its past-only / future-only ablations
(``inpaintnet_tpu/models/latent_rnn.py``).

Past and future contexts sit in fixed buffers of ``max_measures`` with
per-row validity masks; the target in a ``max_target`` buffer. The masked
GRUs (``ops/gru.py``) make the padded runs equal the unpadded ones.

Generation, at inference:
- non-autoregressive (the shipped config): one bidirectional GRU pass over
  a learned constant input ``x_0``, then one batched frozen decode;
- autoregressive (``auto_reg=True``): the generation GRU's input is a z; a
  loop over the target measures runs it one step from the carried hidden,
  decodes that step's z, and re-encodes the sampled measure as the next
  input, starting from the last valid past measure's z. The final
  iteration is peeled: its re-encode would feed nothing, so it never runs.

The random draws are the rsamples of the context latents and, when
autoregressive, of each re-encode. Each comes from a ``torch.Generator``,
from per-row keys (``row_keys``: each row's noise depends on its own key
alone, the serving engine's coalescing contract; an autoregressive model
splits a row's key into a context stream and a re-encode stream,
``ops/distributions.row_split``), or from the caller (``eps``,
``eps_steps``: the parity tests pass the JAX package's draws).

``quant`` ("none" or "int8") selects the frozen VAE's kernels: "int8" runs
K3/K4 (``ops/encoder_kernel.py``, ``ops/decode_kernel.py``).

Training (``apply(train=True)``, the JAX package's ``apply`` at
``train=True``):
- the frozen encoder runs in train mode, its dropout included (the
  trainfast GRU layers, K5 on the card; K1's training mode instead under
  ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``), in one call over past,
  future and, where the teacher-forced branch can read it, the target;
- the context and generation GRUs drop their inter-layer outputs with
  probability ``dropout`` (masks from ``generator``);
- an autoregressive model with teacher forcing flips one coin a batch
  (p 0.5, drawn on the host from ``coin_generator`` unless given): heads,
  one generation pass over the last valid past measure's z and the
  target's z but the last; tails, the sampled loop, re-encoding in train
  mode;
- the decode stays the argmax ``decode_sampling(train=False)``: K2 on the
  card under ``kernel_with_eager_grad`` (its backward re-runs the eager
  scan on the saved inputs, as JAX's ``kernel_with_xla_grad`` does);
- the VAE's parameters take no gradient (JAX's ``stop_gradient``).
In bf16 compute the frozen encoder keeps K5's f32 carry where the JAX
package's LatentRNN trainer runs the XLA scan with a bf16 carry: the two
agree in f32 and round apart in bf16.

The model is a ``CheckpointedModel``: ``params``/``set_params`` hold the
LatentRNN's own parameters (the VAE checkpoints itself), ``save`` and
``load`` read and write the JAX package's ``.npz`` layout at the path its
``repr`` names, which equals the JAX model's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from inpaintnet_tpu_torch.models.base import CheckpointedModel
from inpaintnet_tpu_torch.models.convert import from_functional, latent_rnn_leaves, to_functional
from inpaintnet_tpu_torch.models.measure_vae import (
    NUM_TICKS_PER_MEASURE,
    GRUWeights,
    MeasureVAE,
)
from inpaintnet_tpu_torch.ops.distributions import DiagNormal, row_normal, row_split
from inpaintnet_tpu_torch.ops.gru import gru_apply, gru_init
from inpaintnet_tpu_torch.ops.linear import linear_apply, linear_init


def _frozen(tree):
    """Nested parameters with every leaf that requires a gradient detached
    (JAX's ``stop_gradient``); the others are returned as they are, so the
    kernels' weight caches, keyed by tensor, keep hitting."""
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_frozen(v) for v in tree]
    return tree.detach() if tree.requires_grad else tree


def last_valid_measure(z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, M, z) latents, (B, M) validity -> (B, 1, z): each row's last
    valid measure (the first when none is), not the padded last slot."""
    last = (mask.sum(dim=1).long() - 1).clamp(min=0)
    return z.gather(1, last[:, None, None].expand(-1, 1, z.shape[-1]))


class LatentRNN(CheckpointedModel, nn.Module):
    """:param dataset: its ``repr`` enters the model's (default: the VAE's
        dataset's)
    :param dropout: the context and generation GRUs' inter-layer dropout in
        training
    :param teacher_forcing: an autoregressive model's training flips the
        teacher-forcing coin (ignored when not ``auto_reg``)

    Made on any device but ``meta``, it holds the random parameters that
    ``init_params(numpy.random.default_rng(seed))`` draws."""

    teacher_forcing_prob = 0.5

    def __init__(self, vae_model: MeasureVAE, num_rnn_layers: int,
                 rnn_hidden_size: int, auto_reg: bool = False, max_target: int = 6,
                 device="cuda", *, dataset=None, dropout: float = 0.5,
                 teacher_forcing: bool = True, checkpoint_dir: Optional[str] = None,
                 seed: int = 0):
        nn.Module.__init__(self)
        CheckpointedModel.__init__(self, checkpoint_dir)
        self.dataset_repr = vae_model.dataset_repr if dataset is None else repr(dataset)
        self.vae_model = vae_model.requires_grad_(False)
        self.num_rnn_layers = num_rnn_layers
        self.rnn_hidden_size = rnn_hidden_size
        self.dropout = dropout
        self.auto_reg = auto_reg
        self.use_teacher_forcing = teacher_forcing if auto_reg else False
        self.z_dim = vae_model.latent_space_dim
        self.max_target = max_target
        self.measure_seq_len = NUM_TICKS_PER_MEASURE
        self._check_geometry()
        H, L, z = rnn_hidden_size, num_rnn_layers, self.z_dim
        self.context_rnn_past = GRUWeights(z, H, L, True, device)
        self.context_rnn_future = GRUWeights(z, H, L, True, device)
        self.generation_rnn = GRUWeights(self.gen_input_size, self.gen_hidden_size, L, True,
                                         device)
        self.generation_linear = nn.Linear(2 * self.gen_hidden_size, z, device=device)
        if not auto_reg:
            self.x_0 = nn.Parameter(torch.empty((1, 1, 1), device=device))
        if str(device) != "meta":
            self.set_params(self.init_params(np.random.default_rng(seed)))

    def _repr_kind(self) -> str:
        return ""  # an ablation's type

    def __repr__(self):
        # the JAX package's, so that both name a checkpoint alike
        s = (f"LatentRNN({self._repr_kind()}{self.dataset_repr}GRU,{self.num_rnn_layers},"
             f"{self.rnn_hidden_size},{self.dropout},)")
        if self.auto_reg:
            s += "auto_reg"
        return s + (",tf" if self.use_teacher_forcing else ",no_tf")

    @property
    def gen_hidden_size(self) -> int:
        # generation RNN hidden = H * num_layers
        return self.rnn_hidden_size * self.num_rnn_layers

    @property
    def gen_input_size(self) -> int:
        # the previous measure's z when autoregressive, else the constant x_0
        return self.z_dim if self.auto_reg else 1

    def _check_geometry(self):
        # The generation RNN's initial hidden is the concatenated context
        # (2H wide), so H * L must equal 2H: only num_rnn_layers == 2 closes.
        if self.gen_hidden_size != 2 * self.rnn_hidden_size:
            raise ValueError(
                "LatentRNN requires num_rnn_layers == 2 (generation hidden "
                "H*L must match the concatenated 2H context)")

    def init_params(self, rng: np.random.Generator) -> dict:
        """Random parameters in the JAX package's layout, as numpy."""
        H, L, z = self.rnn_hidden_size, self.num_rnn_layers, self.z_dim
        params = {
            "context_rnn_past": gru_init(rng, z, H, L, True),
            "context_rnn_future": gru_init(rng, z, H, L, True),
            "generation_rnn": gru_init(rng, self.gen_input_size, self.gen_hidden_size, L, True),
            "generation_linear": linear_init(rng, 2 * self.gen_hidden_size, z),
        }
        if not self.auto_reg:
            params["x_0"] = rng.standard_normal((1, 1, 1)).astype(np.float32)
        return params

    def leaves(self):
        return latent_rnn_leaves(self.num_rnn_layers, self.auto_reg)

    def params(self) -> dict:
        """The LatentRNN's own nested (in, out) parameters (the VAE's come
        from ``vae_model.params()``)."""
        own = {k: v for k, v in self.state_dict().items() if not k.startswith("vae_model.")}
        return to_functional(own, self.leaves())

    def set_params(self, params) -> None:
        """Copy the LatentRNN's own nested (in, out) parameters (tensors or
        numpy) into the module, every one of them; the VAE keeps its own."""
        missing, unexpected = self.load_state_dict(from_functional(params, self.leaves()),
                                                   strict=False)
        missing = [k for k in missing if not k.startswith("vae_model.")]
        if missing or unexpected:
            raise KeyError(f"parameters do not match: missing {missing}, "
                           f"unexpected {unexpected}")

    # --- submodules ---------------------------------------------------------- #
    def get_z_seq(self, vae_params, measures: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  row_keys: Optional[torch.Tensor] = None,
                  quant: str = "none", train: bool = False) -> torch.Tensor:
        """(B, M, 24) tokens -> (B, M, z): one batched frozen-encoder call
        and an rsample (not the mean, as the reference does).

        :param eps: optional (B * M, z) noise in place of a draw (the parity
            tests pass the JAX package's)
        :param row_keys: optional (B, 2) integer tensor of uint32 keys, one
            per row: row ``b``'s noise is ``row_normal`` of ``row_keys[b]``
            alone, independent of its batch position and of the other rows
        :param train: the encoder in train mode (its dropout masks drawn
            from ``generator``)
        """
        batch, num_measures, msl = measures.shape
        dist = self.vae_model.encoder.apply(vae_params["encoder"],
                                            measures.reshape(batch * num_measures, msl), quant,
                                            train=train, generator=generator)
        if eps is None and row_keys is not None:
            eps = row_normal(row_keys, (num_measures, self.z_dim)).reshape(-1, self.z_dim)
        z = dist.rsample(generator=generator, eps=eps)
        return z.reshape(batch, num_measures, self.z_dim)

    def encode_context_dists(self, vae_params, past_context: torch.Tensor,
                             future_context: torch.Tensor, quant: str = "none"):
        """One frozen-encoder pass over past + future returning the
        per-measure posteriors without sampling, so a caller can draw many
        variations from one encode (non-autoregressive generation's only
        randomness is this rsample: the argmax decode is deterministic).

        :return: ((loc, scale) of the past, (loc, scale) of the future),
            each (B, M, z)
        """
        batch, max_past, msl = past_context.shape
        measures = torch.cat([past_context, future_context], dim=1)
        dist = self.vae_model.encoder.apply(vae_params["encoder"],
                                            measures.reshape(-1, msl), quant)
        loc, scale = (t.reshape(batch, -1, self.z_dim) for t in dist)
        return ((loc[:, :max_past], scale[:, :max_past]),
                (loc[:, max_past:], scale[:, max_past:]))

    def generate_from_context_dists(self, params, vae_params, past_dist, future_dist, *,
                                    past_mask: torch.Tensor, future_mask: torch.Tensor,
                                    target_mask: torch.Tensor,
                                    generator: Optional[torch.Generator] = None,
                                    eps: Optional[tuple] = None, quant: str = "none"):
        """Non-autoregressive generation from cached context posteriors
        (:meth:`encode_context_dists`); distributed as :meth:`apply`.

        :param past_dist/future_dist: (loc, scale) pairs, (B, M, z) each
        :param eps: optional (past, future) noise pair shaped like the locs
            in place of draws from ``generator``
        :return: (weights, samples, gen_z) like :meth:`apply`
        """
        if self.auto_reg:
            raise ValueError("generate_from_context_dists serves the non-autoregressive "
                             "config only (the autoregressive path re-encodes its samples)")
        eps_p, eps_f = eps if eps is not None else (None, None)
        zp = DiagNormal(*past_dist).rsample(generator=generator, eps=eps_p)
        zf = DiagNormal(*future_dist).rsample(generator=generator, eps=eps_f)
        ctx_p = self.forward_context(params, zp, past_mask, "past")
        ctx_f = self.forward_context(params, zf, future_mask, "future")
        return self._generate_parallel(params, vae_params,
                                       self._combine_contexts(ctx_p, ctx_f), target_mask,
                                       quant)

    def forward_context(self, params, z: torch.Tensor, mask: torch.Tensor,
                        which: str, *, train: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Final bi-GRU hiddens over a masked latent sequence: (L*2, B, H)."""
        p = params["context_rnn_past" if which == "past" else "context_rnn_future"]
        _, h_n = gru_apply(p, z, mask=mask, last_outputs=False, dropout=self.dropout,
                           train=train, generator=generator)
        return h_n

    def _combine_contexts(self, ctx_p: torch.Tensor, ctx_f: torch.Tensor) -> torch.Tensor:
        # concat on the hidden-feature axis: (L*2, B, 2H)
        return torch.cat([ctx_p, ctx_f], dim=2)

    # --- main forward -------------------------------------------------------- #
    def apply(self, params, vae_params, past_context: torch.Tensor,
              future_context: torch.Tensor, target: Optional[torch.Tensor] = None, *,
              past_mask: Optional[torch.Tensor] = None,
              future_mask: Optional[torch.Tensor] = None,
              target_mask: Optional[torch.Tensor] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              coin_generator: Optional[torch.Generator] = None,
              coin: Optional[bool] = None,
              eps: Optional[torch.Tensor] = None,
              eps_steps: Optional[torch.Tensor] = None,
              row_keys: Optional[torch.Tensor] = None,
              quant: str = "none"):
        """The forward, at inference or (``train=True``) in training.

        :param past_context: (B, Mp, 24) int tokens, padded; mask (B, Mp)
        :param future_context: (B, Mf, 24), padded; mask (B, Mf)
        :param target: (B, Mt, 24) or None; at inference only its shape is
            read, and only when ``target_mask`` is None; an autoregressive
            model's teacher-forced training branch encodes it
        :param train: dropout in the frozen encoder and the LatentRNN's
            GRUs (masks from ``generator``), and the teacher-forcing coin
        :param coin_generator: the CPU generator of the teacher-forcing coin;
            :param coin: the coin itself (a test injects the JAX package's)
        :param eps: optional context rsample noise, (B * (Mp + Mf), z), or
            (B * (Mp + Mf + Mt), z) when the target is encoded: the JAX
            package's order of rows
        :param eps_steps: optional (Mt - 1, B, z) noise of the
            autoregressive re-encodes, one per step but the last
        :param row_keys: optional (B, 2) per-row keys, inference only (see
            :meth:`get_z_seq`); an autoregressive model splits each row's
            key into a context stream and a per-step re-encode stream
        :param quant: "none" or "int8", the frozen VAE's kernels at inference
        :return: (weights (B, Mt, 24, V), samples (B, Mt, 24), gen_z (B, Mt, z))
        """
        if train and (row_keys is not None or quant != "none"):
            raise ValueError("training takes neither row_keys nor a quantized VAE: its "
                             "draws come from the generators, its VAE is unquantized")
        vae_params = _frozen(vae_params)
        batch, max_past = past_context.shape[:2]
        max_future = future_context.shape[1]
        if past_mask is None:
            past_mask = past_context.new_ones((batch, max_past), dtype=torch.float32)
        if future_mask is None:
            future_mask = future_context.new_ones((batch, max_future), dtype=torch.float32)
        if target_mask is None:
            if target is None:
                raise ValueError("give target or target_mask: they set the target length")
            target_mask = past_context.new_ones((batch, target.shape[1]), dtype=torch.float32)
        ctx_keys, scan_keys = row_keys, None
        if row_keys is not None and self.auto_reg:
            both = row_split(row_keys, 2)
            ctx_keys, scan_keys = both[:, 0], both[:, 1]

        # One frozen-encoder pass over past + future, and the target where
        # the teacher-forced branch can read its latents (an autoregressive
        # model training with teacher forcing): elsewhere that encode would
        # be dead work.
        need_target = (self.auto_reg and target is not None and train
                       and self.use_teacher_forcing)
        segments = [past_context, future_context] + ([target] if need_target else [])
        z_all = self.get_z_seq(vae_params, torch.cat(segments, dim=1), generator=generator,
                               eps=eps, row_keys=ctx_keys, quant=quant, train=train)
        zp, zf = z_all[:, :max_past], z_all[:, max_past:max_past + max_future]
        ctx_p = self.forward_context(params, zp, past_mask, "past", train=train,
                                     generator=generator)
        ctx_f = self.forward_context(params, zf, future_mask, "future", train=train,
                                     generator=generator)
        context = self._combine_contexts(ctx_p, ctx_f)
        if not self.auto_reg:
            return self._generate_parallel(params, vae_params, context, target_mask, quant,
                                           train=train, generator=generator)
        zp_last = last_valid_measure(zp, past_mask)  # seeds the generation
        if train and self.use_teacher_forcing:
            if coin is None:
                coin = bool(torch.rand((), generator=coin_generator) < self.teacher_forcing_prob)
            if coin:
                zt = z_all[:, max_past + max_future:]
                return self._generate_parallel(
                    params, vae_params, context, target_mask, quant,
                    seed=torch.cat([zp_last, zt[:, :-1]], dim=1), train=True,
                    generator=generator)
        return self._generate_autoregressive(params, vae_params, context, target_mask.shape[1],
                                             zp_last, generator=generator, eps_steps=eps_steps,
                                             row_keys=scan_keys, quant=quant, train=train)

    def _decode_measures(self, vae_params, z_flat: torch.Tensor, quant: str = "none"):
        """Frozen-VAE argmax decode of (N, z) -> (logits (N,24,V), samples
        (N,24)), in training too (``train=False``: no beat-GRU dropout; K2
        where the geometry takes it, differentiable through
        ``kernel_with_eager_grad``)."""
        return self.vae_model.decoder.decode_sampling(vae_params["decoder"], z_flat, quant)

    def _generate_parallel(self, params, vae_params, context: torch.Tensor,
                           target_mask: torch.Tensor, quant: str = "none",
                           seed: Optional[torch.Tensor] = None, *, train: bool = False,
                           generator: Optional[torch.Generator] = None):
        """One bidirectional GRU pass over the target steps, initialised
        with the combined context: from the learned constant input, or from
        ``seed`` (B, Mt, z), the teacher-forced inputs of an autoregressive
        model."""
        batch, max_t = context.shape[1], target_mask.shape[1]
        gen_in = params["x_0"].expand(batch, max_t, 1) if seed is None else seed
        gen_out, _ = gru_apply(params["generation_rnn"], gen_in, context, mask=target_mask,
                               dropout=self.dropout, train=train, generator=generator)
        z_out = linear_apply(params["generation_linear"], gen_out)  # (B, Mt, z)
        logits, samples = self._decode_measures(
            vae_params, z_out.reshape(batch * max_t, self.z_dim), quant)
        return (
            logits.reshape(batch, max_t, self.measure_seq_len, logits.shape[-1]),
            samples.reshape(batch, max_t, self.measure_seq_len),
            z_out,
        )

    def _generate_autoregressive(self, params, vae_params, context: torch.Tensor,
                                 max_t: int, seed: torch.Tensor, *,
                                 generator: Optional[torch.Generator] = None,
                                 eps_steps: Optional[torch.Tensor] = None,
                                 row_keys: Optional[torch.Tensor] = None,
                                 quant: str = "none", train: bool = False):
        """The decode -> re-encode loop over ``max_t`` target measures, the
        final iteration peeled (no re-encode after the last decode). In
        training the generation GRU drops its inter-layer outputs and the
        re-encodes run the encoder in train mode.

        :param seed: (B, 1, z) the first step's input
        :param row_keys: optional (B, 2) re-encode stream keys: step ``i``
            of row ``b`` draws from child ``i`` of ``row_keys[b]``
        :return: as :meth:`apply`
        """
        step_keys = None if row_keys is None else row_split(row_keys, max_t)
        hidden, gen_in = context, seed
        logits, samples, zs = [], [], []
        for i in range(max_t):
            gen_out, hidden = gru_apply(params["generation_rnn"], gen_in, hidden,
                                        dropout=self.dropout, train=train, generator=generator)
            z = linear_apply(params["generation_linear"], gen_out[:, 0])
            lg, s = self._decode_measures(vae_params, z, quant)
            logits.append(lg)
            samples.append(s)
            zs.append(z)
            if i == max_t - 1:
                break
            gen_in = self.get_z_seq(
                vae_params, s[:, None], generator=generator,
                eps=None if eps_steps is None else eps_steps[i],
                row_keys=None if step_keys is None else step_keys[:, i], quant=quant,
                train=train)
        return torch.stack(logits, dim=1), torch.stack(samples, dim=1), torch.stack(zs, dim=1)


class LatentRNNAblations(LatentRNN):
    """Past-only / future-only conditioning ablation: one context feeds the
    generation RNN, whose hidden is ``rnn_hidden_size`` (not scaled by
    layers); ``generation_linear`` reads its 2H outputs."""

    def __init__(self, vae_model: MeasureVAE, num_rnn_layers: int, rnn_hidden_size: int,
                 auto_reg: bool = False, max_target: int = 6, device="cuda",
                 type: str = "past", **kw):
        if type not in ("past", "future"):
            raise ValueError(f"type must be 'past' or 'future', got {type!r}")
        super().__init__(vae_model, num_rnn_layers, rnn_hidden_size, auto_reg, max_target,
                         device, **kw)
        self.type = type

    def _repr_kind(self) -> str:
        return self.type

    @property
    def gen_hidden_size(self) -> int:
        return self.rnn_hidden_size

    def _check_geometry(self):
        pass  # one context's hidden (L*2, B, H) always matches

    def _combine_contexts(self, ctx_p: torch.Tensor, ctx_f: torch.Tensor) -> torch.Tensor:
        return ctx_p if self.type == "past" else ctx_f
