"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

The run (see ``run_cell``):

1. set-up: torch is imported and the card's context made (``main``), the
   configuration's build function (``problems/<type>.py``) builds the
   system under test through the port's own functions, the problem
   type's reference (``reference/<type>.py``) draws the mix's pool of
   right-hand sides on the device from the seed, and the solve is warmed
   up; ``setup_s`` runs from the process's start to here;
2. the window: one caller solves back to back, each solve ended by a
   device synchronisation, the pool in turn, until ``seconds`` have
   passed and at least the mix's sample size of solves has completed; a
   sample of the solves, drawn from the seed, keeps its answers;
3. with ``trace``: the mix's ``trace_solves`` further solves twice, first
   with the subject's hooked entry timed on the host's clock and no
   profiler, then under the profiler; the per-layer metrics read both;
4. the device's memory peak is read, the program's state freed, and the
   reference (``reference/<type>.py``) judges the answers.

No module of JAX or of tpufem may be loaded after set-up or after the
window: the run then fails before it prints a result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import pathlib
import random
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from fembench import trace as trace_mod

IMPORTED = time.perf_counter()     # torch and the harness are imported
ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "fembench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufem")


class RunError(Exception):
    """A run that cannot give a result: no chip, a forbidden import."""


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot)
    is, whole, one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: modules of JAX or tpufem are loaded: "
                       + ", ".join(found))


def load_module(kind: str, name: str):
    """``fembench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {kind} module {name!r} at {path}")
    mod_name = f"fembench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_spec(path: Optional[pathlib.Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> dict:
    """The cell ``workload`` of ``spec``, with its configuration and mix
    read from their files."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return dict(workload=w, config=config, mix=mix)


def metrics_for(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's metrics: its end-to-end ones, or with ``traced`` its
    per-layer ones."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def run_cell(c: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, t0: float,
             subject_factory: Optional[Callable] = None,
             marks: Sequence[Tuple[str, float]] = ()) -> dict:
    """Steps 1-4 of the module's docstring for the cell ``c`` (``cell``).
    ``subject_factory(config, mix, device)`` replaces the configuration's
    build function (the control puts the reference in the program's place).
    ``marks``: (phase, the clock at its end) of set-up before this call,
    from ``t0`` on.  Returns the run's record, with ``checks`` and
    ``failed``."""
    config, mix = c["config"], c["mix"]
    if mix.get("loop") != "closed" or int(mix.get("callers", 0)) != 1:
        raise RunError("the generator drives one caller in a closed loop: "
                       f"mix {mix.get('name')!r} asks for "
                       f"{mix.get('loop')!r} with {mix.get('callers')!r}")
    ptype = config["problem_type"]
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    factory = subject_factory or load_module("problems", ptype).build
    reference = load_module("reference", ptype)

    # 1. set-up
    marks = [("start", t0)] + list(marks) + [("harness", time.perf_counter())]
    subject = factory(config, mix, device)
    marks.append(("program", time.perf_counter()))
    pool = reference.rhs_pool(seed, int(mix["pool"]), mix, subject.dtype,
                              device)
    sync()
    marks.append(("pool", time.perf_counter()))
    for k in range(int(mix["warm_solves"])):
        subject.solve(pool[k % len(pool)])
    sync()
    marks.append(("warm-up", time.perf_counter()))
    guard("after set-up")
    record = dict(setup_s=time.perf_counter() - t0, seed=seed,
                  problem_type=ptype,
                  lattice=tuple(subject.lattice),
                  ndofs=int(subject.ndofs),
                  itemsize=torch.empty((), dtype=subject.dtype).element_size(),
                  registry=subject.registry(),
                  setup_phases={b[0]: b[1] - a[1]
                                for a, b in zip(marks, marks[1:])})

    # 2. the window
    keep = int(mix["sample"])
    rng = random.Random(seed)
    sample: List[dict] = []
    solves = []
    start = time.perf_counter()
    i = 0
    while True:
        k = i % len(pool)
        ts = time.perf_counter()
        try:
            x, it, rel = subject.solve(pool[k])
            sync()
            it, rel = int(it), float(rel)
        except Exception:  # a failed request is counted, the caller goes on
            traceback.print_exc()
            x, it, rel = None, -1, math.nan
        te = time.perf_counter()
        solves.append((ts - start, te - start, it, rel, k))
        # reservoir sample of the answers (Algorithm R), drawn from the seed
        j = i if i < keep else rng.randrange(i + 1)
        if j < keep and x is not None:
            item = dict(pool=k, rel=rel, x=x.clone())
            if j < len(sample):
                sample[j] = item
            else:
                sample.append(item)
        i += 1
        if te - start >= seconds and i >= keep:
            break
    sync()
    guard("after the window")
    record["solves"] = solves

    # 3. the timed and the traced stretch
    if traced:
        record["timed"] = _timed(subject, pool, int(mix["trace_solves"]), sync)
        record.update(_traced(subject, pool, int(mix["trace_solves"]), sync))
        guard("after the traced stretch")
        record["card"] = power_limit() if device.type == "cuda" else None

    # 4. memory, then the reference
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    record["memory_peak_bytes"] = peak
    del subject
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    record["checks"] = reference.check(record, pool, sample, config, mix,
                                       device)
    record["reference_s"] = time.perf_counter() - t_ref
    # a request that raised, or answered no finite residual, failed
    record["failed"] = sum(1 for s in solves
                           if s[2] < 0 or not math.isfinite(s[3]))
    return record


class HostTimer:
    """Calls and host seconds inside ``with timer(name):``, by name."""

    def __init__(self) -> None:
        self.ranges: Dict[str, dict] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            r = self.ranges.setdefault(name, dict(calls=0, host_s=0.0))
            r["calls"] += 1
            r["host_s"] += time.perf_counter() - t


def _timed(subject, pool: torch.Tensor, n: int, sync) -> dict:
    """``n`` solves with no profiler, the subject's hooked entry timed on
    the host's clock: the stretch's wall to its last synchronisation
    (``wall_s``) and each hooked range's calls and host seconds."""
    timer = HostTimer()
    sync()
    t = time.perf_counter()
    with subject.instrumented(timer):
        for i in range(n):
            subject.solve(pool[i % len(pool)])
            sync()
    return dict(wall_s=time.perf_counter() - t, ranges=timer.ranges)


def _traced(subject, pool: torch.Tensor, n: int, sync) -> dict:
    """``n`` solves under the profiler, each in a ``fembench.solve``
    range, with the subject's own ranges on; what ``trace.reduce`` reads
    of them, and their iterations."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and pool.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    its = 0
    with subject.instrumented(record_function), \
            profile(activities=acts) as prof:
        for i in range(n):
            with record_function(trace_mod.SOLVE_RANGE):
                _, it, _ = subject.solve(pool[i % len(pool)])
                sync()
            its += int(it)
    t = time.perf_counter()
    summary = trace_mod.reduce(prof.profiler.kineto_results.events(),
                               ranges=subject.ranges)
    return dict(trace=summary, trace_iterations=its,
                trace_reduce_s=time.perf_counter() - t)


def correct(record: dict) -> bool:
    """Every request answered and every number within its limit."""
    return record["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in record["checks"])


def result(spec: dict, workload: str, record: dict, traced: bool,
           device: torch.device) -> dict:
    """The run's result line: the cell's metrics as their readers find
    them, the device, with ``trace`` its busy time and the breakdown, and
    last the numbers compared with their limits."""
    metrics = {}
    for m in metrics_for(spec, workload, traced):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(record["memory_peak_bytes"]))
    out = dict(correct=correct(record), attempted=len(record["solves"]),
               failed=record["failed"], metrics=metrics, device=dev)
    summary = record.get("trace")
    if traced and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        if record.get("card"):
            dev["card"] = record["card"]
        out["breakdown"] = dict(device_ops=summary["device_ops"],
                                idle_gaps=summary["idle_gaps"])
    out["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                     for c in record["checks"]}
    return out


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="fembench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]], t0: float) -> int:
    args = parse(argv)
    try:
        spec = load_spec()
        c = cell(spec, args.workload)
        chips = int(c["workload"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(
                f"{args.workload} needs {chips} CUDA device(s); "
                f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                f"device_count() = {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.zeros(1, device=device)       # the card's context
        torch.cuda.synchronize(device)
        record = run_cell(c, args.seed, args.seconds, bool(args.trace),
                          device, t0, marks=[("import", IMPORTED),
                                             ("cuda", time.perf_counter())])
        out = result(spec, args.workload, record, bool(args.trace), device)
        guard("before the result")
    except RunError as e:
        print(f"fembench: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"fembench: setup {record['setup_s']:.3f} s "
          + json.dumps({k: round(v, 3) for k, v in
                        record["setup_phases"].items()})
          + " stages " + json.dumps({k: round(v, 3) for k, v in
                                     record["registry"].items()})
          + f", {len(record['solves'])} solves, reference "
          f"{record['reference_s']:.3f} s"
          + (f", trace reduced in {record['trace_reduce_s']:.3f} s"
             if args.trace else ""), file=sys.stderr)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
