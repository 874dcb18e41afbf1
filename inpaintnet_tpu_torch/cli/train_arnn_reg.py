"""Train or evaluate the AnticipationRNN "gaussian reg" variant
(``train_arnn_reg.py``; reference train_arnn_reg.py:12-135, the same flags
and ``--device``). It differs from the baseline only in its trainer's
contiguous-span constraint masks: the reference never adds the gaussian
regularizer to the loss.

    python -m inpaintnet_tpu_torch.cli.train_arnn_reg [--device cpu] ...
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli.common import (
    ARNN_OPTIONS,
    add_options,
    build_arnn,
    compute_dtype_option,
    dataset_options,
    device_option,
    flag_pair,
    standard_datasets,
    train_device,
    trainer_dtype,
)


def build_parser(description: str = __doc__.splitlines()[0]) -> argparse.ArgumentParser:
    """The options both ARNN training scripts take."""
    parser = argparse.ArgumentParser(description=description)
    add_options(parser, [
        ("note_embedding_dim", 10, "size of the note embeddings"),
        ("metadata_embedding_dim", 2, "size of the metadata embeddings"),
        *ARNN_OPTIONS,
        ("batch_size", 32, "training batch size"),
        ("num_epochs", 50, "number of training epochs"),
    ])
    flag_pair(parser, "train", "test", True, "train or evaluate the model")
    flag_pair(parser, "log", "no_log", True, "log epoch metrics")
    add_options(parser, [("lr", 1e-4, "learning rate")])
    flag_pair(parser, "plot", "no_plot", True, "plot the training log")
    flag_pair(parser, "teacher_forcing", "no_teacher_forcing", True, "use teacher forcing")
    flag_pair(parser, "early_stop", "no_early_stop", True, "use early stopping")
    compute_dtype_option(parser)
    dataset_options(parser)
    device_option(parser)
    return parser


def run(args, kind: str):
    """Train (or load, with ``--test``) the ARNN of ``kind`` ("reg" or
    "baseline") of the parsed options, then test it. -> (test loss, test
    accuracy)"""
    from inpaintnet_tpu_torch.eval import AnticipationRNNTester
    from inpaintnet_tpu_torch.train import (
        AnticipationRNNBaselineTrainer,
        AnticipationRNNGaussianRegTrainer,
    )

    device = train_device(args.device)
    folk_dataset, folk_dataset_test = standard_datasets(
        args.dataset_name, cache_dir=args.cache_dir, corpus_dir=args.corpus_dir)
    model = build_arnn(args, folk_dataset, device, kind, teacher_forcing=args.teacher_forcing)
    if args.train:
        trainer_cls = (AnticipationRNNGaussianRegTrainer if kind == "reg"
                       else AnticipationRNNBaselineTrainer)
        trainer = trainer_cls(folk_dataset, model, lr=args.lr,
                              compute_dtype=trainer_dtype(args.compute_dtype),
                              early_stopping=args.early_stop, device=device)
        trainer.train_model(batch_size=args.batch_size, num_epochs=args.num_epochs,
                            plot=args.plot, log=args.log)
    else:
        model.load()
    return AnticipationRNNTester(folk_dataset_test, model).test_model(batch_size=512)


def main(argv=None):
    """-> (test loss, test accuracy)"""
    return run(build_parser().parse_args(argv), "reg")


if __name__ == "__main__":
    main()
