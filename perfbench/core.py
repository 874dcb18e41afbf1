"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result.

Everything a cell names is found by name (``find``): the configuration
``configs/<config>.json`` (its ``family`` names the program adapter
``systems/<family>.py`` and the plain reference ``reference/<family>.py``),
the traffic mix ``traffic/<traffic>.json``, whose ``driver`` names the
module ``drivers/<driver>.py`` that makes its requests (with the one
generator, ``generator.py``) and drives the window, and each metric
``metrics/<metric>.py``, or, where that file is not there, the reader of
the name's part before its first dot (``idle_share.bulk`` ->
``metrics/idle_share.py``), whose ``read(ctx)`` returns a number or None.

After the window: the peak memory is read, the program is freed, and the
sampled rows go through the reference in float32.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.trace import ReplayClock, Tracer
from perfbench.weights import make_weights

HERE = Path(__file__).resolve().parent
DIRS = {kind: HERE / kind for kind in ("traffic", "drivers", "metrics", "systems", "reference")}
FORBIDDEN = ("jax", "jaxlib", "flax", "inpaintnet_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KINDS = {"bfloat16": "bf16", "float32": "f32", "int8": "int8"}


def load_module(path: Path):
    """A module of the benchmark's own, by its file."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str) -> Path:
    """The file of a part by its name: ``<kind>/<name>.py``; a metric
    without a file of its own takes its name's reader before the first
    dot."""
    path = DIRS[kind] / f"{name}.py"
    if kind == "metrics" and not path.is_file():
        path = DIRS[kind] / f"{name.split('.')[0]}.py"
    return path


def load_spec(root: Path = HERE.parent) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(spec: dict, name: str) -> tuple:
    """(cell, configuration entry, configuration, traffic mix) of a cell."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(HERE.parent / entry["file"]) as f:
        cfg = json.load(f)
    with open(DIRS["traffic"] / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, entry, cfg, mix


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones without a
    trace, its per-layer ones with one."""
    e2e = [m for m in spec["end_to_end"]
           if m["name"] == "setup_s" or cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


class Call:
    """One call of a traced run outside its traced calls: its requests, its
    cycle (host clock, from making the request to the end of copying the
    rows out), the engine call's wall, and the replay clock's marks
    around it."""

    def __init__(self, requests: list, cycle_s: float, call_s: float, marks: tuple):
        self.requests, self.cycle_s, self.call_s, self.marks = requests, cycle_s, call_s, marks
        self.replay_s = None


class Window:
    """What a driver's window gives back."""

    def __init__(self):
        self.attempted = self.failed = self.measures = 0
        self.window_s = 0.0
        self.latencies, self.kept, self.served, self.traced = [], [], [], []
        self.calls, self.lines = [], []


class Context:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.notes = []

    def note(self, line: str) -> None:
        self.notes.append(line)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", spec: dict = None, parts: tuple = None,
             variant: str = None, fault=None, imported: float = None) -> tuple:
    """One run. -> (result dict, lines for standard error, forbidden
    modules loaded).

    ``parts`` replaces the cell's files (tests pass small ones);
    ``variant="control"`` swaps in the configuration's control (the
    program's lower-precision path, or the reference's, as the family's
    adapter says); ``fault(requests, outputs)`` breaks the outputs where
    they are produced (tests)."""
    spec = spec or load_spec()
    _, _, cfg, mix = parts or cell_parts(spec, cell_name)
    family = cfg["family"]
    system_mod = load_module(find("systems", family))
    ref_mod = load_module(find("reference", family))
    driver = load_module(find("drivers", mix["driver"]))
    cuda = torch.device(device).type == "cuda"
    lines = []

    marks = [("start", t0)] + ([("imports", imported)] if imported else [])
    seq = np.random.SeedSequence(seed)
    w_seed, t_seed = (int(s.generate_state(1, np.uint64)[0]) >> 1 for s in seq.spawn(2))
    weights = make_weights(ref_mod.param_specs(cfg), w_seed, device, DTYPES[cfg["param_dtype"]],
                           cfg["init_gain"])
    traffic = driver.traffic(mix, cfg, t_seed)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights and traffic", time.perf_counter()))
    system = system_mod.System(cfg, {n: t.clone() for n, t in weights.items()}, device,
                               control=variant == "control")
    lines.append(f"route: {system.describe()}")
    marks += system.phases + [("engine", time.perf_counter())]
    marks += driver.warm(system, traffic, cuda)
    setup_s = marks[-1][1] - t0
    lines.append("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                        in zip(marks, marks[1:])))

    tracer = Tracer(trace, cuda)
    with ReplayClock(trace and cuda) as clock:
        w = driver.window(system, traffic, seconds, tracer=tracer, clock=clock, trace=trace,
                          fault=fault)
        for c in w.calls:
            c.replay_s = clock.seconds(*c.marks)
    lines += w.lines

    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    untraced = [r for c in w.calls for r in c.requests]
    ctx = Context(cfg=cfg, setup_s=setup_s, window_s=w.window_s, latencies=w.latencies,
                  measures=w.measures, timeline=tracer.timeline, traced=w.traced,
                  calls=w.calls, counters=system.counters(),
                  kind=KINDS[cfg["serve_dtype"]],
                  work=ref_mod.work(cfg, w.traced) if w.traced else None,
                  calls_work=ref_mod.work(cfg, untraced) if untraced else None)
    metrics = {}
    for m in metrics_of(spec, cell_name, trace):
        value = load_module(find("metrics", m["name"])).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    lines += ctx.notes
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    kept = w.kept
    sample = traffic.check_sample(kept) if kept else []
    w32 = {n: t.float() for n, t in weights.items()}
    del weights
    if sample:
        checks = ref_mod.check(w32, cfg, sample, **system_mod.check_options(variant))
    else:
        checks = {"widest_gap": float("inf"), "outside_span_changed": -1, "info": {}}
    info = checks.pop("info")
    lines.append("check info: " + ", ".join(f"{k} {v}" for k, v in info.items()))
    limits = cfg["limits"]
    compared = {n: {"value": checks[n], "limit": limits[n]} for n in limits}
    correct = (w.failed == 0 and w.attempted > 0 and bool(sample)
               and all(c["value"] <= c["limit"] for c in compared.values()))
    for n, c in compared.items():
        lines.append(f"check {n}: {c['value']!r} limit {c['limit']!r}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak),
                   "power_limit": power_limit() if cuda else "none"}
    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": device_info}
    if trace and tracer.timeline is not None:
        device_info["busy_s"] = tracer.timeline.busy_s
        device_info["window_s"] = tracer.timeline.window_s
        result["breakdown"] = tracer.timeline.breakdown()
    result["checks"] = compared
    return result, lines, forbidden_modules()
