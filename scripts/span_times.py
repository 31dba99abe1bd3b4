"""What the solve path's spans (tpufem_torch/timing.py) cost and read in
the benchmark's two cells, on the card.

    python scripts/span_times.py                 # both 10M cells, on the card
    python scripts/span_times.py --ndofs 20000   # a rehearsal on the CPU

Each cell of BENCHMARK.json is built and warmed up as ``fembench``
builds it; then, in the harness's own stretches of the mix's
``trace_solves`` solves (``harness._timed`` and ``harness._traced``):

1. two rounds of four stretches without the profiler, spans off, on, on,
   off: the ms a solve of each (the cost of spans left on), and the
   spans' summary (calls, host and self seconds, counters) of the last
   stretch with spans on;
2. two stretches under the profiler, spans off then on, reduced by
   ``fembench/trace.py`` with the span names as extra ranges: the kernels
   an iteration either way, and each span's kernels and device seconds.

Without a CUDA device it stops, unless ``--ndofs`` asks for the CPU
rehearsal, where each cell's mix is cut to about that many dofs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from fembench import harness  # noqa: E402

CELLS = ("cgpoisson_p1_cube.10m", "poisson_p1_cube_gmg.10m")


def run_cell(name: str, device: torch.device, ndofs: int = 0) -> dict:
    """Steps 1-2 of the module's docstring for the cell ``name``;
    ``ndofs`` cuts the mix for a CPU rehearsal, and only there."""
    from tpufem_torch import timing
    if device.type != "cuda" and not ndofs:
        raise ValueError(f"{name} runs at full size on the card only")
    c = harness.cell(harness.load_spec(), name)
    config, mix = c["config"], dict(c["mix"])
    if ndofs:
        mix["ndofs"] = ndofs
    ptype = config["problem_type"]
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    subject = harness.load_module("problems", ptype).build(config, mix,
                                                           device)
    pool = harness.load_module("reference", ptype).rhs_pool(
        2147483001, int(mix["pool"]), mix, subject.dtype, device)
    for k in range(int(mix["warm_solves"])):
        subject.solve(pool[k % len(pool)])
    sync()
    n, hook = int(mix["trace_solves"]), subject.ranges[0]

    turns = []
    for on in (False, True, True, False) * 2:
        timing.enable_spans(on)
        timing.SPANS.reset()
        t = harness._timed(subject, pool, n, sync)
        turns.append(dict(spans=on, solve_ms=1e3 * t["wall_s"] / n,
                          hooked=t["ranges"].get(hook)))
        if on:
            summary = timing.SPANS.summary()

    subject.ranges = [hook] + sorted(summary["spans"])
    traced = []
    for on in (False, True):
        timing.enable_spans(on)
        t = harness._traced(subject, pool, n, sync)
        traced.append(dict(t["trace"], spans=on,
                           iterations=t["trace_iterations"]))
    timing.enable_spans(False)
    timing.SPANS.reset()
    return dict(cell=name, ndofs=int(subject.ndofs), solves=n, hook=hook,
                turns=turns,
                spans=summary["spans"], counters=summary["counters"],
                traced=traced)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scripts/span_times.py")
    p.add_argument("--ndofs", type=int, default=0,
                   help="rehearse on the CPU, each cell cut to about this "
                   "many dofs")
    args = p.parse_args(argv)
    if args.ndofs:
        device, card = torch.device("cpu"), "cpu rehearsal"
    elif torch.cuda.is_available():
        device, card = torch.device("cuda", 0), harness.power_limit()
    else:
        p.error("no CUDA device: the cells run on the card (--ndofs N "
                "rehearses them on the CPU)")
    print(f"card: {card}")
    for name in CELLS:
        r = run_cell(name, device, args.ndofs)
        print(f"== {r['cell']} ({r['ndofs']} dofs, {r['solves']} solves a "
              "stretch)")
        for t in r["turns"]:
            print(f"  spans {'on ' if t['spans'] else 'off'}: "
                  f"{t['solve_ms']:.4f} ms a solve, hooked "
                  + json.dumps(t["hooked"]))
        print("  counters: " + json.dumps(r["counters"]))
        on = r["traced"][1]
        for t in r["traced"]:
            print(f"  profiled, spans {'on ' if t['spans'] else 'off'}: "
                  f"{t['kernels'] / t['iterations']:.4f} kernels an "
                  f"iteration, busy {t['busy_s']:.6f} of {t['window_s']:.6f}"
                  f" s, {r['hook']} " + json.dumps(t["ranges"][r["hook"]])
                  + ", idle gaps " + json.dumps(t["idle_gaps"][:6]))
        for span, s in r["spans"].items():
            d = on["ranges"].get(span) or {}
            print(f"  {span:<18} calls {s['calls']:>6}  host {s['host_s']:.6f}"
                  f"  self {s['self_s']:.6f}  kernels {d.get('kernels')}"
                  f"  device {d.get('device_s')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
