"""Train or evaluate a LatentRNN ablation conditioned on one context
(``train_inpaintnet_ablation.py``; reference
train_inpaintnet_ablation.py:15-193, the same flags and ``--device``).

    python -m inpaintnet_tpu_torch.cli.train_inpaintnet_ablation --context_type past ...
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli.common import compute_dtype_option, dataset_options, device_option
from inpaintnet_tpu_torch.cli.train_inpaintnet import add_latent_training_options, run


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_latent_training_options(parser, num_epochs=50, plot=True, early_stop=True)
    parser.add_argument("--context_type", default="past", choices=["past", "future"],
                        help="which single context conditions generation")
    compute_dtype_option(parser)
    dataset_options(parser)
    device_option(parser)
    return parser


def main(argv=None):
    """-> (test loss, test accuracy)"""
    args = build_parser().parse_args(argv)
    return run(args, ablation=args.context_type)


if __name__ == "__main__":
    main()
