"""AnticipationRNN: the constraint-conditioned LSTM family
(``inpaintnet_tpu/models/anticipation_rnn.py``).

- a *constraint* LSTM stack runs BACKWARDS over the embedded metadata and
  the unary-constraint note embeddings (``output_lstm_constraints``), with
  an optional per-row tick mask that holds its state across a padded
  suffix;
- a *generation* LSTM stack takes [previous-note embedding, constraint
  output] per tick; the autoregressive decode is one loop over the ticks
  (``_sampled_scan``), with the ticks of ``force_mask`` fed the ground
  truth.

The argmax decode (``temperature=None``) of a 2-layer model whose widths
the kernel takes runs K7 (``ops/arnn_kernel.py``), as the JAX package
routes it to its Pallas kernel; everything else runs the eager scan.
Temperature sampling takes explicit Gumbel noise (``ops/sampling.py``):
given, from per-row keys, or from a ``torch.Generator``.

Training (``apply(train=True)``) flips one teacher-forcing coin a batch
(p 0.5, drawn on the host from ``coin_generator`` unless given): heads run
``forward_tf``, one teacher-forced pass whose generation stack reads zeros
at tick 0 and the previous tick's note embedding after it; tails run the
eager argmax loop under autograd, never K7 (as the JAX package never takes
its kernel in training). Dropout acts between the layers of both LSTM
stacks and, teacher-forced, on whole ticks of the shifted note embeddings.
Its keep masks come from ``generator``, or from ``masks`` (a test passes
the JAX package's draws): ``{"constraint": [...], "generation": [...],
"input": (B, T, 1)}``, each stack's list one (B, T, H) mask a non-last
layer. The constraint stack's masks are in its own, time-reversed, order.

The modules hold their parameters under the reference's ``state_dict``
names (``convert.anticipation_rnn_leaves``); the functional methods take
the nested (in, out) parameters that ``params()`` returns.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from inpaintnet_tpu_torch.models.base import CheckpointedModel
from inpaintnet_tpu_torch.models.convert import (
    anticipation_rnn_leaves,
    from_functional,
    to_functional,
)
from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_kernel_supports, arnn_sampled_decode
from inpaintnet_tpu_torch.ops.gru import apply_dropout, dropout_keep
from inpaintnet_tpu_torch.ops.kernel_common import kernel_with_eager_grad
from inpaintnet_tpu_torch.ops.linear import (
    embedding_apply,
    embedding_init,
    linear_apply,
    linear_init,
)
from inpaintnet_tpu_torch.ops.lstm import lstm_cell_apply, lstm_stack_apply, lstm_stack_init
from inpaintnet_tpu_torch.ops.sampling import (
    gumbel,
    row_gumbel,
    sample_argmax,
    sample_categorical,
)


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """(B, T, E) -> the previous tick's rows, zeros at tick 0: the
    teacher-forced pass's input (the sampled loop feeds START instead)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


class LSTMWeights(nn.Module):
    """One layer's parameters under ``torch.nn.LSTM``'s names and shapes
    (``weight_ih_l0`` (4H, in), ...). A container only: the recurrence is
    ``ops.lstm`` or K7, never cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        for name, shape in (("weight_ih_l0", (4 * hidden_size, input_size)),
                            ("weight_hh_l0", (4 * hidden_size, hidden_size)),
                            ("bias_ih_l0", (4 * hidden_size,)),
                            ("bias_hh_l0", (4 * hidden_size,))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device)))


class ConstraintModelGaussianReg(CheckpointedModel, nn.Module):
    """Made on any device but ``meta``, it holds the random parameters that
    ``init_params(numpy.random.default_rng(seed))`` draws. It lives on the
    card unless ``device`` says otherwise."""

    teacher_forcing_prob = 0.5

    def __init__(self, dataset, note_embedding_dim: int = 20,
                 metadata_embedding_dim: int = 30, num_lstm_constraints_units: int = 256,
                 num_lstm_generation_units: int = 256, linear_hidden_size: int = 128,
                 num_layers: int = 1, dropout_input_prob: float = 0.2,
                 dropout_prob: float = 0.5, unary_constraint: bool = False,
                 teacher_forcing: bool = True, checkpoint_dir: Optional[str] = None,
                 device="cuda", seed: int = 0):
        nn.Module.__init__(self)
        CheckpointedModel.__init__(self, checkpoint_dir)
        self.dataset = dataset
        self.dataset_repr = repr(dataset)
        self.use_teacher_forcing = teacher_forcing
        self.num_layers = num_layers
        self.num_units_linear = linear_hidden_size
        self.unary_constraint = unary_constraint
        self.note_embedding_dim = note_embedding_dim
        self.metadata_embedding_dim = metadata_embedding_dim
        self.num_lstm_constraints_units = num_lstm_constraints_units
        self.num_lstm_generation_units = num_lstm_generation_units
        self.dropout_input_prob = dropout_input_prob
        self.dropout_prob = dropout_prob
        self.num_notes = len(dataset.note2index_dicts[0])
        self.start_index = dataset.note2index_dicts[0].get("START", 0)
        # metadata channels: the dataset's metadatas + the trailing voice id
        self.num_elements_per_metadata: List[int] = [
            md.num_values for md in dataset.metadatas
        ] + [getattr(dataset, "num_voices", 1)]
        self.no_constraint_index = self.num_notes  # the extra token

        uc = 1 if unary_constraint else 0
        self.note_embeddings = nn.ModuleList(
            [nn.Embedding(self.num_notes + uc, note_embedding_dim, device=device)])
        self.lstm_constraint = nn.ModuleList(
            [LSTMWeights(i, h, device) for i, h in self._constraint_sizes()])
        self.lstm_generation = nn.ModuleList(
            [LSTMWeights(i, h, device) for i, h in self._generation_sizes()])
        self.linear_1 = nn.Linear(num_lstm_generation_units, linear_hidden_size, device=device)
        self.linear_ouput_notes = nn.ModuleList(  # [sic], the reference's name
            [nn.Linear(linear_hidden_size, self.num_notes, device=device)])
        self.metadata_embeddings = nn.ModuleList(
            [nn.Embedding(n, metadata_embedding_dim, device=device)
             for n in self.num_elements_per_metadata])
        if str(device) != "meta":
            self.set_params(self.init_params(np.random.default_rng(seed)))

    def __repr__(self):
        name = type(self).__name__.replace("ConstraintModelGaussianReg", "AnticipationRNNReg")
        s = (f"{name}({self.dataset_repr},{self.note_embedding_dim},"
             f"{self.metadata_embedding_dim},{self.num_lstm_constraints_units},"
             f"{self.num_lstm_generation_units},{self.num_units_linear},"
             f"{self.num_layers},{self.dropout_input_prob},{self.dropout_prob},"
             f"{self.unary_constraint},)")
        return s + (",tf" if self.use_teacher_forcing else ",no_tf")

    # --- params -------------------------------------------------------------- #
    def _constraint_sizes(self):
        c_in = (self.metadata_embedding_dim * len(self.num_elements_per_metadata)
                + self.note_embedding_dim * (1 if self.unary_constraint else 0))
        c = self.num_lstm_constraints_units
        return [(c_in, c)] + [(c, c)] * (self.num_layers - 1)

    def _generation_sizes(self):
        g = self.num_lstm_generation_units
        return ([(self.note_embedding_dim + self.num_lstm_constraints_units, g)]
                + [(g, g)] * (self.num_layers - 1))

    def init_params(self, rng: np.random.Generator) -> dict:
        """Random parameters in the JAX package's layout, as numpy."""
        uc = 1 if self.unary_constraint else 0
        return {
            "note_embedding": embedding_init(rng, self.num_notes + uc, self.note_embedding_dim),
            "lstm_constraint": lstm_stack_init(rng, self._constraint_sizes()),
            "lstm_generation": lstm_stack_init(rng, self._generation_sizes()),
            "linear_1": linear_init(rng, self.num_lstm_generation_units, self.num_units_linear),
            "linear_output_notes": linear_init(rng, self.num_units_linear, self.num_notes),
            "metadata_embeddings": [embedding_init(rng, n, self.metadata_embedding_dim)
                                    for n in self.num_elements_per_metadata],
        }

    def leaves(self):
        return anticipation_rnn_leaves(self.num_layers, len(self.num_elements_per_metadata))

    def params(self) -> dict:
        """The nested (in, out) parameters the functional methods take."""
        return to_functional(self.state_dict(), self.leaves())

    def set_params(self, params) -> None:
        """Copy nested (in, out) parameters (tensors or numpy) into the
        module, strictly."""
        self.load_state_dict(from_functional(params, self.leaves()), strict=True)

    # --- shared pieces ----------------------------------------------------------- #
    def mask_tensor_score(self, score: torch.Tensor, constraints_loc: torch.Tensor):
        """Unconstrained ticks become the no-constraint token."""
        return score * constraints_loc + self.no_constraint_index * (1 - constraints_loc)

    def embed_metadata(self, params, metadata: torch.Tensor, score=None, constraints_loc=None):
        """(B, T, num_md) -> (B, T, md_dim * num_md [+ note_dim])."""
        parts = [embedding_apply(emb, metadata[:, :, i])
                 for i, emb in enumerate(params["metadata_embeddings"])]
        if score is not None and self.unary_constraint:
            masked = self.mask_tensor_score(score, constraints_loc)
            parts.append(embedding_apply(params["note_embedding"], masked))
        return torch.cat(parts, dim=-1)

    def output_lstm_constraints(self, params, embedded_metadata: torch.Tensor,
                                tick_mask: Optional[torch.Tensor] = None, *,
                                train: bool = False,
                                generator: Optional[torch.Generator] = None,
                                dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        """The constraint LSTM over the reversed sequence.

        :param tick_mask: optional (B, T) validity mask (1 = real tick;
            padding is a SUFFIX): the reversed loop meets the padding first
            and holds its zero state there, so a row's constraint outputs at
            its valid ticks equal its unpadded run's
        :param train, generator, dropout_masks: the stack's inter-layer
            dropout (``lstm_stack_apply``); the masks lie over the reversed
            sequence, as the stack sees it
        :return: (outputs (B, T, C), per-layer outputs in reversed order)
        """
        rev = embedded_metadata.flip(1)
        rev_mask = None if tick_mask is None else tick_mask.flip(1)
        out, _, all_hs = lstm_stack_apply(params["lstm_constraint"], rev, mask=rev_mask,
                                          train=train, dropout=self.dropout_prob,
                                          generator=generator, dropout_masks=dropout_masks)
        return out.flip(1), all_hs

    def _head(self, params, gen_out: torch.Tensor) -> torch.Tensor:
        h = torch.relu(linear_apply(params["linear_1"], gen_out))
        return linear_apply(params["linear_output_notes"], h)

    def _drop_input(self, x: torch.Tensor, *, train: bool,
                    generator: Optional[torch.Generator] = None,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Timestep dropout (the reference's ``Dropout2d`` over (B, T, E, 1)):
        whole ticks of ``x`` dropped with probability ``dropout_input_prob``
        by a (B, T, 1) keep mask, given or drawn from ``generator``."""
        rate = self.dropout_input_prob
        if not train or rate <= 0.0:
            return x
        if keep is None:
            keep = dropout_keep(x.shape[:2] + (1,), rate, generator, x.device)
        return apply_dropout(x, keep, rate)

    def _start_embedding(self, params, batch: int) -> torch.Tensor:
        table = params["note_embedding"]["table"]
        tok = torch.full((batch,), self.start_index, dtype=torch.long, device=table.device)
        return embedding_apply(params["note_embedding"], tok)

    # --- forward paths ------------------------------------------------------------- #
    def forward_tf(self, params, score: torch.Tensor, metadata: torch.Tensor,
                   constraints_loc: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None, masks: Optional[dict] = None,
                   return_activations: bool = False):
        """The teacher-forced pass over all ticks: the generation stack reads
        [previous tick's note embedding (zeros at tick 0), constraint
        output] in one pass per layer.

        :param masks: optional keep masks (see the module docstring), else
            drawn from ``generator``
        :return: logits (B, T, V) [, (generation activations, constraint
            activations), each a list of per-layer (B, T, H) outputs]
        """
        masks = masks or {}
        m = self.embed_metadata(params, metadata, score, constraints_loc)
        constraint_out, c_acts = self.output_lstm_constraints(
            params, m, train=train, generator=generator,
            dropout_masks=masks.get("constraint"))
        offset = shift_right(embedding_apply(params["note_embedding"], score))
        offset = self._drop_input(offset, train=train, generator=generator,
                                  keep=masks.get("input"))
        gen_out, _, g_acts = lstm_stack_apply(
            params["lstm_generation"], torch.cat([offset, constraint_out], dim=-1),
            train=train, dropout=self.dropout_prob, generator=generator,
            dropout_masks=masks.get("generation"))
        logits = self._head(params, gen_out)
        if return_activations:
            return logits, (g_acts, c_acts)
        return logits

    def forward_sampled(self, params, score: torch.Tensor, metadata: torch.Tensor,
                        constraints_loc: torch.Tensor, *,
                        force_mask: Optional[torch.Tensor] = None, temperature=None,
                        generator: Optional[torch.Generator] = None,
                        row_keys: Optional[torch.Tensor] = None,
                        gumbel_noise: Optional[torch.Tensor] = None,
                        tick_mask: Optional[torch.Tensor] = None, train: bool = False,
                        masks: Optional[dict] = None):
        """The autoregressive decode over all ticks.

        :param score: (B, T) int tokens; metadata (B, T, num_md) int;
            constraints_loc (B, T) int, 1 where the tick is constrained
        :param force_mask: (B, T) 1 where the *input token* is forced to the
            ground truth; None = never
        :param temperature: None = argmax; else sample from
            ``logits * temperature`` (the reference multiplies), a scalar or
            a (B,) per-row vector
        :param gumbel_noise: optional (B, T, V) Gumbel noise of the sampling
            (the parity tests pass the JAX package's draws); else drawn per
            row from ``row_keys`` ((B, 2) uint32 values, each row's stream
            its key's alone), else from ``generator``
        :param tick_mask: optional (B, T) validity mask of suffix-padded rows
            (only the reversed constraint loop needs it)
        :param train: the training branch: the constraint stack's dropout
            (keep masks ``masks["constraint"]`` or drawn from ``generator``)
            and the eager loop, never K7
        :return: (logits (B, T, V), tokens (B, T) int32)
        """
        batch, seq_len = score.shape
        m = self.embed_metadata(params, metadata, score, constraints_loc)
        constraint_out, _ = self.output_lstm_constraints(
            params, m, tick_mask, train=train, generator=generator,
            dropout_masks=(masks or {}).get("constraint"))
        if force_mask is None:
            force_mask = torch.zeros_like(score)
        if temperature is None and not train and self._use_kernel_decode(params):
            # K7's forward; under a gradient, the eager argmax loop's
            # backward at the same inputs (JAX's kernel_with_xla_grad)
            decode = kernel_with_eager_grad(
                arnn_sampled_decode,
                lambda p, ctx, sc, fm, se: self._sampled_scan(
                    p, ctx, sc, fm, start_emb=se.expand(sc.shape[0], se.shape[-1])))
            return decode(params, constraint_out, score.to(torch.int32).contiguous(),
                          force_mask.to(torch.int32).contiguous(), self._start_embedding(params, 1))
        if temperature is not None and gumbel_noise is None:
            gumbel_noise = (row_gumbel(row_keys, seq_len, self.num_notes) if row_keys is not None
                            else gumbel((batch, seq_len, self.num_notes), generator,
                                        score.device))
        return self._sampled_scan(params, constraint_out, score, force_mask,
                                  start_emb=self._start_embedding(params, batch),
                                  temperature=temperature, gumbel_noise=gumbel_noise)

    def _use_kernel_decode(self, params) -> bool:
        """K7 takes 2 generation layers, its dtypes, H up to 512 (bf16: 640)
        and any C (narrow ones on zero units, ``arnn_kernel_supports``)."""
        return self.num_layers == 2 and arnn_kernel_supports(
            self.num_lstm_generation_units, self.num_lstm_constraints_units,
            self.num_units_linear, self.num_notes,
            params["lstm_generation"][0]["w_hh"].dtype)

    def _sampled_scan(self, params, constraint_out: torch.Tensor, score: torch.Tensor,
                      force_mask: torch.Tensor, *, start_emb: torch.Tensor, temperature=None,
                      gumbel_noise: Optional[torch.Tensor] = None):
        """The eager loop of the decode (the JAX package's XLA scan): per
        tick the generation stack on [previous embedding, constraint
        output], the head, argmax or a categorical draw, and the force
        mask's ground truth."""
        batch, seq_len = score.shape
        hidden = self.num_lstm_generation_units
        zeros = constraint_out.new_zeros((batch, hidden))
        h = [zeros] * self.num_layers
        c = [zeros] * self.num_layers
        if temperature is not None:
            temp = torch.as_tensor(temperature, dtype=torch.float32, device=score.device)
            temp = temp[:, None] if temp.ndim else temp
        gen = params["lstm_generation"]
        prev = start_emb
        logits_all, tokens = [], []
        for t in range(seq_len):
            inp = torch.cat([prev, constraint_out[:, t]], dim=-1)
            for layer in range(self.num_layers):
                h[layer], c[layer] = lstm_cell_apply(gen[layer], (h[layer], c[layer]), inp)
                inp = h[layer]
            logits = self._head(params, inp)
            if temperature is None:
                sampled = sample_argmax(logits)
            else:
                sampled = sample_categorical(logits.float() * temp, gumbel_noise[:, t])
            token = torch.where(force_mask[:, t] > 0, score[:, t].long(), sampled)
            prev = embedding_apply(params["note_embedding"], token)
            logits_all.append(logits)
            tokens.append(token)
        return torch.stack(logits_all, dim=1), torch.stack(tokens, dim=1).to(torch.int32)

    def apply(self, params, score, metadata, constraints_loc, *, train: bool = False,
              generator: Optional[torch.Generator] = None,
              coin_generator: Optional[torch.Generator] = None, coin: Optional[bool] = None,
              masks: Optional[dict] = None):
        """The logits the trainers score. Outside training, or without
        teacher forcing, the argmax decode with nothing forced (K7 where it
        takes the geometry and no gradient is asked for: the trainers'
        validation). In training with teacher forcing, one coin a batch:
        heads :meth:`forward_tf`, tails the sampled branch.

        :param generator: draws the dropout keep masks unless ``masks``
            gives them (see the module docstring)
        :param coin_generator: the CPU generator of the teacher-forcing coin;
        :param coin: the coin itself (a test injects the JAX package's)
        """
        if train and self.use_teacher_forcing:
            if coin is None:
                coin = bool(torch.rand((), generator=coin_generator) < self.teacher_forcing_prob)
            if coin:
                return self.forward_tf(params, score, metadata, constraints_loc, train=True,
                                       generator=generator, masks=masks)
        return self.forward_sampled(params, score, metadata, constraints_loc, train=train,
                                    generator=generator, masks=masks)[0]

    def apply_inpaint(self, params, score, metadata, constraints_loc, *,
                      tick_mask: Optional[torch.Tensor] = None):
        """Inpainting decode: ticks where ``constraints_loc == 1`` feed the
        ground truth; the masked span decodes by argmax.

        :return: (logits (B, T, V), tokens (B, T) int32)
        """
        return self.forward_sampled(params, score, metadata, constraints_loc,
                                    force_mask=constraints_loc, tick_mask=tick_mask)

    def generate(self, params, score, metadata, constraints_loc, *, temperature=1.0,
                 generator: Optional[torch.Generator] = None,
                 row_keys: Optional[torch.Tensor] = None,
                 gumbel_noise: Optional[torch.Tensor] = None,
                 tick_mask: Optional[torch.Tensor] = None):
        """Temperature sampling over the whole sequence, context ticks forced
        as in :meth:`apply_inpaint` (noise as :meth:`forward_sampled` says).

        :return: (logits (B, T, V), tokens (B, T) int32)
        """
        return self.forward_sampled(params, score, metadata, constraints_loc,
                                    force_mask=constraints_loc, temperature=temperature,
                                    generator=generator, row_keys=row_keys,
                                    gumbel_noise=gumbel_noise, tick_mask=tick_mask)


class AnticipationRNNBaseline(ConstraintModelGaussianReg):
    """The same model; it differs only in its name (its ``repr`` begins
    ``AnticipationRNNBaseline(``) and its trainer's constraint-mask scheme."""
