"""Train or evaluate the AnticipationRNN baseline (``train_arnn_baseline.py``;
reference train_arnn_baseline.py:12-135, the same flags and ``--device``).

    python -m inpaintnet_tpu_torch.cli.train_arnn_baseline [--device cpu] ...
"""
from __future__ import annotations

import argparse

from inpaintnet_tpu_torch.cli import train_arnn_reg


def build_parser() -> argparse.ArgumentParser:
    return train_arnn_reg.build_parser(__doc__.splitlines()[0])


def main(argv=None):
    """-> (test loss, test accuracy)"""
    return train_arnn_reg.run(build_parser().parse_args(argv), "baseline")


if __name__ == "__main__":
    main()
