"""Corpus preparation (``prepare_corpus.py``, the same subcommands and flags).

    # split a downloaded sessions_data_clean.txt dump into per-tune files
    python -m inpaintnet_tpu_torch.cli.prepare_corpus split \\
        --dump sessions_data_clean.txt --out_dir dataset_cache/raw_data

    # or make a synthetic corpus for smoke runs
    python -m inpaintnet_tpu_torch.cli.prepare_corpus synth \\
        --out_dir dataset_cache/raw_data --num_tunes 200

    # run the validity filter and print the corpus's statistics
    python -m inpaintnet_tpu_torch.cli.prepare_corpus stats \\
        --corpus_dir dataset_cache/raw_data
"""
from __future__ import annotations

import argparse


def split(args) -> None:
    from inpaintnet_tpu_torch.data.corpus import split_raw_dump

    n = split_raw_dump(args.dump, args.out_dir)
    print(f"wrote {n} tunes to {args.out_dir}")


def synth(args) -> None:
    from inpaintnet_tpu_torch.data.synthetic import generate_corpus

    num, den = (int(x) for x in args.time_sig.split("/"))
    names = generate_corpus(args.out_dir, args.num_tunes, args.num_bars, args.seed, (num, den))
    print(f"wrote {len(names)} synthetic tunes to {args.out_dir}")


def stats(args) -> None:
    from inpaintnet_tpu_torch.data.corpus import FolkCorpus

    sigs = [tuple(int(x) for x in ts.split("/")) for ts in args.time_sigs.split(",")]
    corpus = FolkCorpus(raw_dir=args.corpus_dir, time_sigs=sigs, cache_dir=args.cache_dir)
    print(f"valid tunes: {len(corpus.valid_tune_filenames)}")
    s = corpus.scan_dataset()
    print(f"files scanned: {s['num_files']}")
    print(f"pitch range: [{s['min_pitch']}, {s['max_pitch']}]")
    print(f"time signatures: {s['time_signatures']}")
    print(f"duration histogram: {s['dur_dist']}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Corpus preparation.")
    commands = parser.add_subparsers(dest="command", required=True)
    p = commands.add_parser("split")
    p.add_argument("--dump", required=True, help="path to sessions_data_clean.txt")
    p.add_argument("--out_dir", default="dataset_cache/raw_data")
    p.set_defaults(run=split)
    p = commands.add_parser("synth")
    p.add_argument("--out_dir", default="dataset_cache/raw_data")
    p.add_argument("--num_tunes", type=int, default=200)
    p.add_argument("--num_bars", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time_sig", default="4/4")
    p.set_defaults(run=synth)
    p = commands.add_parser("stats")
    p.add_argument("--corpus_dir", default="dataset_cache/raw_data")
    p.add_argument("--cache_dir", default="dataset_cache")
    p.add_argument("--time_sigs", default="4/4", help="comma-separated, e.g. 3/4,4/4")
    p.set_defaults(run=stats)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.run(args)


if __name__ == "__main__":
    main()
