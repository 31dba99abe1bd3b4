"""The readings that the limits of ``correct`` are set from.

    python3 fembench/control.py --workload <cell> --seeds 1 2 3 [--subject S]

For each seed, a run of the cell as ``harness.run_cell`` makes it, with
a window of the mix's sample size of solves, judged by the cell's
reference, and one line of JSON with the numbers compared.  ``--subject``
says what answers:

- ``tf32`` (the control): the plain reference put in the program's place,
  its CG in float32 with the operator's products in TF32, the precision
  below the configuration's float32 with TF32 off.  The limits have to
  fail it;
- ``float32``: the same reference at the configuration's precision,
  which has to pass;
- ``program``: the system under test, built once for all seeds.

The control's solver is the reference's CG without a preconditioner, to
the configuration's ``rtol`` within the ``control.max_it`` steps the
configuration gives it (``reference/<type>.py: control_subject``).  The
readings are taken on the card, ``cuda:0``, or with ``readings(...,
device)`` where a test gives another.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

from fembench import harness


def readings(workload: str, seeds: List[int], subject: str,
             device: torch.device, spec: Optional[dict] = None) -> List[dict]:
    """One dict a seed: the seed, ``correct`` and the numbers compared."""
    c = harness.cell(spec or harness.load_spec(), workload)
    cached = {}

    def factory(config, mix, dev):
        if subject != "program":
            return harness.load_module(
                "reference", config["problem_type"]).control_subject(
                    config, mix, dev, subject)
        if "s" not in cached:
            cached["s"] = harness.load_module(
                "problems", config["problem_type"]).build(config, mix, dev)
        return cached["s"]

    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        rec = harness.run_cell(c, seed, 0.0, False, device, t0,
                               subject_factory=factory)
        out.append(dict(seed=seed, subject=subject,
                        correct=harness.correct(rec),
                        iterations=[s[2] for s in rec["solves"]],
                        checks={ch["name"]: ch["value"]
                                for ch in rec["checks"]},
                        limits={ch["name"]: ch["limit"]
                                for ch in rec["checks"]},
                        seconds=time.perf_counter() - t0))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="fembench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--subject", default="tf32",
                   choices=("tf32", "float32", "program"))
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    for r in readings(args.workload, args.seeds, args.subject, device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
