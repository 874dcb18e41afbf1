"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload latent512.bulk --seed 7 --seconds 20 --trace 0

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations, traffic mixes and metrics; ``core.py`` runs one. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with the plain reference beside
its limit; the same numbers are the last lines of standard error.

It exits with another code than 0, and prints no result, when there is no
CUDA card or fewer than the cell asks for, when ``jax``, ``jaxlib``,
``flax`` or ``inpaintnet_tpu`` is loaded once the window has closed, or
when anything fails. Caches of compiled kernels stay in fixed directories
under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_jit"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import core

    imported = time.perf_counter()

    spec = core.load_spec(ROOT)
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines, loaded = core.run_cell(args.workload, args.seed, args.seconds,
                                          bool(args.trace), t0=T0, spec=spec,
                                          imported=imported)
    if loaded:
        print(f"modules of the JAX package or of JAX were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
