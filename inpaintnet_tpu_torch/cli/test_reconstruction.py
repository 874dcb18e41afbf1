"""Joint inpainting evaluation (``test_reconstruction.py``; reference
test_reconstruction.py:56-361, the same flags and ``--device``): the
LatentRNN, both AnticipationRNNs and, with ``--include_ablations``, the
LatentRNN ablations, scored on the same stochastic splits with a fixed
number of target measures, each model's accuracy also split into target
measures that repeat a context measure and novel ones.

    python -m inpaintnet_tpu_torch.cli.test_reconstruction [--device cpu] ...

Every model's forward runs on the device: the LatentRNNs' frozen encoder
on K1 and their decode on K2, the AnticipationRNNs' decode on K7, where
the geometries take them. The scores stay on the device until the end of
the loop.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.cli.common import (
    ARNN_OPTIONS,
    LATENT_RNN_OPTIONS,
    add_options,
    build_arnn,
    build_latent_rnn,
    build_vae,
    dataset_options,
    device_option,
    resolve_device,
    standard_datasets,
    vae_options,
)
from inpaintnet_tpu_torch.eval.vae_tester import to_device
from inpaintnet_tpu_torch.ops.sampling import sample_argmax
from inpaintnet_tpu_torch.train.latent_rnn_trainer import target_tick_mask
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss


def process_batch_data(batch, latent_rnn_tester, arnn_tester, num_target_measures=2):
    """One stochastic split shared by both families -> (the LatentRNN's
    packed split, the ARNN's (score, metadata, constraints_loc, start
    tick, end tick)), numpy (reference test_reconstruction.py:224-252)."""
    score_tensor = np.asarray(batch[0])
    metadata_tensor = np.asarray(batch[1])
    packed = latent_rnn_tester.split_score_stochastic(score_tensor,
                                                      fix_num_target=num_target_measures)
    num_past = int(packed[1][0].sum())
    loc, start_tick, end_tick = arnn_tester.get_constraints_location(
        score_tensor, start_measure=num_past, num_measures=num_target_measures)
    b = score_tensor.shape[0]
    score = score_tensor.reshape(b, -1).astype(np.int32)
    md = metadata_tensor.reshape(b, score.shape[1], -1).astype(np.int32)
    return packed, (score, md, loc.reshape(b, -1).astype(np.int32), start_tick, end_tick)


def _context_repeat_flags(score_2d, num_past, num_target, msl=24):
    """(B, num_target) bool: target measure j is an exact token copy of
    some context measure of its own window. On corpora with phrase forms
    (``data/synthetic.py``'s structured style) this splits the eval into
    restated measures, where a model can use long-range context, and novel
    ones it must model locally."""
    b = score_2d.shape[0]
    meas = score_2d.reshape(b, -1, msl)
    flags = np.zeros((b, num_target), bool)
    for i in range(b):
        ctx = {m.tobytes() for j, m in enumerate(meas[i])
               if not num_past <= j < num_past + num_target}
        for j in range(num_target):
            flags[i, j] = meas[i, num_past + j].tobytes() in ctx
    return flags


def loss_and_acc_test(data_loader, latent_rnn_tester, arnn_tester, arnn_baseline_tester=None,
                      num_target_measures=2, num_models=4, ablation_testers=None,
                      noise: Optional[Sequence[dict]] = None,
                      predictions: Optional[dict] = None) -> dict:
    """Each model's mean NLL and accuracy over the batches (reference
    test_reconstruction.py:255-357), and its accuracy on repeated and on
    novel target measures (:func:`_context_repeat_flags`).

    :param ablation_testers: optional ``{name: LatentRNNTester}`` of
        ablations, scored through the same splits as the main models
    :param noise: optional sequence, one dict of ``LatentRNNTester.noise``'s
        keys a batch, given to every LatentRNN in place of their draws (a
        test passes the JAX package's)
    :param predictions: optional dict; each model's argmax tokens of the
        scored ticks, (B, num_target, 24) numpy, are appended to
        ``predictions[name]`` batch by batch
    :return: {metric: float}
    """
    ablation_testers = ablation_testers or {}
    names = ["latent_rnn", "arnn", "arnn_baseline", *ablation_testers]
    scores = {f"{n}_{k}": [] for n in names for k in ("loss", "acc")}
    # per model: [repeat correct, repeat total, novel correct, novel total]
    grp = {n: [] for n in names}
    msl = 24
    nb = 0
    with torch.inference_mode():
        for i, batch in enumerate(data_loader):
            nb += 1
            latent_batch, arnn_batch = process_batch_data(batch, latent_rnn_tester, arnn_tester,
                                                          num_target_measures)
            score_np, md, loc, start_tick, end_tick = arnn_batch
            num_past = start_tick // msl
            rep = to_device(_context_repeat_flags(score_np, num_past, num_target_measures, msl),
                            latent_rnn_tester.device)[:, :, None]
            score = to_device(score_np, arnn_tester.device)

            def accumulate(name, pred, target):
                """pred, target: (B, num_target, msl) tokens on the device."""
                corr = pred == target
                grp[name].append(torch.stack([(corr & rep).sum(), rep.expand_as(corr).sum(),
                                              (corr & ~rep).sum(), (~rep).expand_as(corr).sum()]))
                if predictions is not None:
                    predictions.setdefault(name, []).append(pred.cpu().numpy())

            def arnn_eval(name, tester):
                logits, _ = tester.inpaint(score, md, loc)
                span = logits[:, start_tick:end_tick]
                tgt = score[:, start_tick:end_tick]
                shape = (span.shape[0], num_target_measures, msl)
                accumulate(name, sample_argmax(span).reshape(shape), tgt.reshape(shape))
                scores[f"{name}_loss"].append(mean_crossentropy_loss(span, tgt))
                scores[f"{name}_acc"].append(mean_accuracy(span, tgt))

            def latent_eval(name, tester):
                weights, _, _ = tester.forward(
                    latent_batch,
                    noise[i] if noise is not None else tester.noise(i, score.shape[0]))
                target = to_device(latent_batch[4], tester.device)
                tick_mask = target_tick_mask(to_device(latent_batch[5], tester.device), msl)
                scores[f"{name}_loss"].append(
                    mean_crossentropy_loss(weights, target, mask=tick_mask))
                scores[f"{name}_acc"].append(mean_accuracy(weights, target, mask=tick_mask))
                # the packed target's rows 0..num_target-1 are the measures
                # num_past..num_past+num_target-1 (a fixed-size split)
                accumulate(name, sample_argmax(weights)[:, :num_target_measures],
                           target[:, :num_target_measures])

            if num_models >= 1:
                arnn_eval("arnn", arnn_tester)
            if num_models >= 2:
                latent_eval("latent_rnn", latent_rnn_tester)
            for name, tester in ablation_testers.items():
                latent_eval(name, tester)
            if num_models >= 4 and arnn_baseline_tester is not None:
                arnn_eval("arnn_baseline", arnn_baseline_tester)
    # read from the device once the loop ends; Python sums in batch order, as the JAX script's
    nb = max(nb, 1)
    out = {k: sum(torch.stack(v).tolist()) / nb if v else 0.0 for k, v in scores.items()}
    counts = {n: np.sum(torch.stack(v).tolist(), axis=0) if v else np.zeros(4)
              for n, v in grp.items()}
    tot = counts["arnn"][1] + counts["arnn"][3]
    if tot:
        out["repeat_fraction"] = counts["arnn"][1] / tot
        for name, g in counts.items():
            if g[1]:
                out[f"{name}_acc_repeat"] = g[0] / g[1]
            if g[3]:
                out[f"{name}_acc_novel"] = g[2] / g[3]
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_options(parser, vae_options(has_metadata=True) + LATENT_RNN_OPTIONS + ARNN_OPTIONS,
                with_help=False)
    add_options(parser, [("batch_size", 512, None),
                         ("num_target", 2, "fixed number of target measures"),
                         ("num_models", 4, None)])
    parser.add_argument("--include_ablations", default="",
                        help='comma list of LatentRNNAblations context types ("past","future") '
                             "to score as extra rows; their checkpoints must exist "
                             "(train_inpaintnet_ablation.py or benchmarks/full_schedule.py "
                             "ablation phase)")
    dataset_options(parser)
    device_option(parser)
    return parser


def build_testers(args):
    """The test split's loader and the testers of the trained checkpoints
    of the parsed options. -> (loader, latent tester, ARNN tester, ARNN
    baseline tester, {name: ablation tester})"""
    from inpaintnet_tpu_torch.eval import AnticipationRNNTester, LatentRNNTester

    device = resolve_device(args.device)
    folk_dataset_train, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    vae_model = build_vae(args, folk_dataset_train, device).load()
    latent_rnn = build_latent_rnn(args, folk_dataset_train, vae_model, device,
                                  auto_reg=False).load()
    ablation_testers = {
        f"ablation_{ctx_type}": LatentRNNTester(
            folk_dataset_test, build_latent_rnn(args, folk_dataset_train, vae_model, device,
                                                auto_reg=False, ablation=ctx_type).load())
        for ctx_type in [s for s in args.include_ablations.split(",") if s]}
    arnn = build_arnn(args, folk_dataset_train, device, "reg").load()
    arnn_baseline = build_arnn(args, folk_dataset_train, device, "baseline").load()
    _, _, gen_test = folk_dataset_test.data_loaders(batch_size=args.batch_size,
                                                    split=(0.01, 0.01))
    return (gen_test, LatentRNNTester(folk_dataset_test, latent_rnn),
            AnticipationRNNTester(folk_dataset_test, arnn),
            AnticipationRNNTester(folk_dataset_test, arnn_baseline), ablation_testers)


def main(argv=None) -> dict:
    """Print and return :func:`loss_and_acc_test`'s results."""
    args = build_parser().parse_args(argv)
    gen_test, latent_tester, arnn_tester, arnn_baseline_tester, ablations = build_testers(args)
    results = loss_and_acc_test(gen_test, latent_tester, arnn_tester, arnn_baseline_tester,
                                num_target_measures=args.num_target,
                                num_models=args.num_models, ablation_testers=ablations)
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
