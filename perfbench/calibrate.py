"""Readings that a cell's limits are set from: the program's compared
numbers on many seeds, and the control's on a few, each a short run of the
cell at its own size, all in one process (the kernel library loads once).

    python3 perfbench/calibrate.py --workload latent512.bulk --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2 --out chiprun_out/calibrate.json

The control is the configuration's lower precision: the program's own
int8 path for a LatentRNN, the float8 reference's first tokens for an
AnticipationRNN (``systems/<family>.py``). The benchmark's runs never run
it. Prints one line a run and writes every reading to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import core

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    spec = core.load_spec(ROOT)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    out = []
    for seed, variant in runs:
        t0 = time.perf_counter()
        result, lines, _ = core.run_cell(args.workload, seed, args.seconds, False, t0=t0,
                                         spec=spec, variant=variant)
        info = next((ln for ln in lines if ln.startswith("check info")), "")
        row = {"seed": seed, "variant": variant or "program", "correct": result["correct"],
               "attempted": result["attempted"],
               "checks": {n: c["value"] for n, c in result["checks"].items()}, "info": info,
               "seconds": time.perf_counter() - t0}
        out.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
