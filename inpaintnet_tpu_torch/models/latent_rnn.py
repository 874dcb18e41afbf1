"""LatentRNN (InpaintNet), non-autoregressive inference, over a frozen
MeasureVAE (``inpaintnet_tpu/models/latent_rnn.py``).

Past and future contexts sit in fixed buffers of ``max_measures`` with
per-row validity masks; the target in a ``max_target`` buffer. The masked
GRU loops (``ops/gru.py``) make the padded runs equal the unpadded ones.
The per-measure ``rsample`` of the context latents is the only random draw:
from a ``torch.Generator``, from per-row keys (``row_keys``: each row's noise
depends on its own key alone, the serving engine's coalescing contract), or
given by the caller (``eps``).

``quant`` ("none" or "int8") selects the frozen VAE's kernels: "int8" runs
K3/K4 (``ops/encoder_kernel.py``, ``ops/decode_kernel.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from inpaintnet_tpu_torch.models.convert import latent_rnn_leaves, to_functional
from inpaintnet_tpu_torch.models.measure_vae import (
    NUM_TICKS_PER_MEASURE,
    GRUWeights,
    MeasureVAE,
)
from inpaintnet_tpu_torch.ops.distributions import DiagNormal, row_normal
from inpaintnet_tpu_torch.ops.gru import gru_apply, gru_init
from inpaintnet_tpu_torch.ops.linear import linear_apply, linear_init


class LatentRNN(nn.Module):
    def __init__(self, vae_model: MeasureVAE, num_rnn_layers: int,
                 rnn_hidden_size: int, auto_reg: bool = False, max_target: int = 6,
                 device=None):
        super().__init__()
        if auto_reg:
            raise NotImplementedError(
                "the autoregressive LatentRNN is not ported yet (ROADMAP queue 1 item 8)")
        self.vae_model = vae_model
        self.num_rnn_layers = num_rnn_layers
        self.rnn_hidden_size = rnn_hidden_size
        self.z_dim = vae_model.latent_space_dim
        self.max_target = max_target
        self.measure_seq_len = NUM_TICKS_PER_MEASURE
        self._check_geometry()
        H, L, z = rnn_hidden_size, num_rnn_layers, self.z_dim
        self.context_rnn_past = GRUWeights(z, H, L, True, device)
        self.context_rnn_future = GRUWeights(z, H, L, True, device)
        self.generation_rnn = GRUWeights(1, self.gen_hidden_size, L, True, device)
        self.generation_linear = nn.Linear(4 * H, z, device=device)
        self.x_0 = nn.Parameter(torch.empty((1, 1, 1), device=device))

    @property
    def gen_hidden_size(self) -> int:
        # generation RNN hidden = H * num_layers
        return self.rnn_hidden_size * self.num_rnn_layers

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
        return {
            "context_rnn_past": gru_init(rng, z, H, L, True),
            "context_rnn_future": gru_init(rng, z, H, L, True),
            "generation_rnn": gru_init(rng, 1, self.gen_hidden_size, L, True),
            "generation_linear": linear_init(rng, 4 * H, z),
            "x_0": rng.standard_normal((1, 1, 1)).astype(np.float32),
        }

    def params(self) -> dict:
        """The LatentRNN's own nested (in, out) parameters (the VAE's come
        from ``vae_model.params()``)."""
        own = {k: v for k, v in self.state_dict().items() if not k.startswith("vae_model.")}
        return to_functional(own, latent_rnn_leaves(self.num_rnn_layers))

    # --- submodules ---------------------------------------------------------- #
    def get_z_seq(self, vae_params, measures: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  row_keys: Optional[torch.Tensor] = None,
                  quant: str = "none") -> torch.Tensor:
        """(B, M, 24) tokens -> (B, M, z): one batched frozen-encoder call
        and an rsample (not the mean, as the reference does).

        :param eps: optional (B * M, z) noise in place of a draw (the parity
            tests pass the JAX package's)
        :param row_keys: optional (B, 2) integer tensor of uint32 keys, one
            per row: row ``b``'s noise is ``row_normal`` of ``row_keys[b]``
            alone, independent of its batch position and of the other rows
        """
        batch, num_measures, msl = measures.shape
        dist = self.vae_model.encoder.apply(vae_params["encoder"],
                                            measures.reshape(batch * num_measures, msl), quant)
        if eps is None and row_keys is not None:
            eps = row_normal(row_keys, (num_measures, self.z_dim)).reshape(-1, self.z_dim)
        z = dist.rsample(generator=generator, eps=eps)
        return z.reshape(batch, num_measures, self.z_dim)

    def encode_context_dists(self, vae_params, past_context: torch.Tensor,
                             future_context: torch.Tensor, quant: str = "none"):
        """One frozen-encoder pass over past + future returning the
        per-measure posteriors without sampling, so a caller can draw many
        variations from one encode (generation's only randomness is this
        rsample: the argmax decode is deterministic).

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
        """Generation from cached context posteriors
        (:meth:`encode_context_dists`); distributed as :meth:`apply`.

        :param past_dist/future_dist: (loc, scale) pairs, (B, M, z) each
        :param eps: optional (past, future) noise pair shaped like the locs
            in place of draws from ``generator``
        :return: (weights, samples, gen_z) like :meth:`apply`
        """
        eps_p, eps_f = eps if eps is not None else (None, None)
        zp = DiagNormal(*past_dist).rsample(generator=generator, eps=eps_p)
        zf = DiagNormal(*future_dist).rsample(generator=generator, eps=eps_f)
        ctx_p = self.forward_context(params, zp, past_mask, "past")
        ctx_f = self.forward_context(params, zf, future_mask, "future")
        return self._generate_parallel(params, vae_params,
                                       self._combine_contexts(ctx_p, ctx_f), target_mask,
                                       quant)

    def forward_context(self, params, z: torch.Tensor, mask: torch.Tensor,
                        which: str) -> torch.Tensor:
        """Final bi-GRU hiddens over a masked latent sequence: (L*2, B, H)."""
        p = params["context_rnn_past" if which == "past" else "context_rnn_future"]
        _, h_n = gru_apply(p, z, mask=mask, last_outputs=False)
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
              generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None,
              row_keys: Optional[torch.Tensor] = None,
              quant: str = "none"):
        """Inference forward.

        :param past_context: (B, Mp, 24) int tokens, padded; mask (B, Mp)
        :param future_context: (B, Mf, 24), padded; mask (B, Mf)
        :param target: (B, Mt, 24) or None; only its shape is read when
            ``target_mask`` is None
        :param eps: optional (B * (Mp + Mf), z) rsample noise
        :param row_keys: optional (B, 2) per-row keys of the rsample (see
            :meth:`get_z_seq`)
        :param quant: "none" or "int8", the frozen VAE's kernels
        :return: (weights (B, Mt, 24, V), samples (B, Mt, 24), gen_z (B, Mt, z))
        """
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

        # One frozen-encoder pass over past + future. The target is never
        # encoded: only the autoregressive teacher-forced branch reads its
        # latents, so in this config that encode would be dead work.
        z_all = self.get_z_seq(vae_params, torch.cat([past_context, future_context], dim=1),
                               generator=generator, eps=eps, row_keys=row_keys, quant=quant)
        zp, zf = z_all[:, :max_past], z_all[:, max_past:]
        ctx_p = self.forward_context(params, zp, past_mask, "past")
        ctx_f = self.forward_context(params, zf, future_mask, "future")
        return self._generate_parallel(params, vae_params,
                                       self._combine_contexts(ctx_p, ctx_f), target_mask,
                                       quant)

    def _decode_measures(self, vae_params, z_flat: torch.Tensor, quant: str = "none"):
        """Frozen-VAE argmax decode of (N, z) -> (logits (N,24,V), samples (N,24))."""
        return self.vae_model.decoder.decode_sampling(vae_params["decoder"], z_flat, quant)

    def _generate_parallel(self, params, vae_params, context: torch.Tensor,
                           target_mask: torch.Tensor, quant: str = "none"):
        """One bidirectional GRU pass over the target steps from a learned
        constant input, initialised with the 2H-wide combined context."""
        batch, max_t = context.shape[1], target_mask.shape[1]
        gen_in = params["x_0"].expand(batch, max_t, 1)
        gen_out, _ = gru_apply(params["generation_rnn"], gen_in, context, mask=target_mask)
        z_out = linear_apply(params["generation_linear"], gen_out)  # (B, Mt, z)
        logits, samples = self._decode_measures(
            vae_params, z_out.reshape(batch * max_t, self.z_dim), quant)
        return (
            logits.reshape(batch, max_t, self.measure_seq_len, logits.shape[-1]),
            samples.reshape(batch, max_t, self.measure_seq_len),
            z_out,
        )
