#!/usr/bin/env python3
"""Does the port need tpufem's host-memory tuning (tpufem/hostmem.py)?

tpufem tunes glibc's allocator and pre-faults host pages because the TPU
VM it ran on provisioned a fresh page slowly: its docstring gives 16-160
MB/s for the first touch of a page against 1.1-4.5 GB/s for a touch of a
page the guest already held.  This script measures the same two rates on
the host it runs on, and whether tpufem's preamble (``mallopt``, the
heap prefault, the detached page warm-up) moves the stages of a CLI run
there.

    python scripts/hostmem_probe.py [--gib 2] [--pairs 3] [--no-cli]
        [--no-touch] [--variants plain,mallopt,prefault,tpufem]
        [--json PATH] [-- CLI ARGS]

1. Page touches, each in a fresh process: ``--gib`` GiB of anonymous
   memory mapped and written once a 4 KiB page (first touch), then
   unmapped, mapped anew and written again (re-touch: the pages come
   back from the kernel's free lists), then written a third time without
   unmapping (no fault: the floor of the loop).  A second process then
   maps and touches the same size (first touch in a process after
   another has freed its pages).
2. The CLI, default ``--problem_type poisson --mesh_type unstructured
   --ndofs 500000 --scaling_type strong --dtype float32 -ksp_max_it 120
   --device cuda`` (the spoke P1 500k row), ``--pairs`` rounds of the
   ``--variants`` in turn, forwards then backwards, one process a run:
   ``plain`` (no tuning: the CLI's call switched off), ``mallopt``
   (tune_allocator: ``mallopt(M_MMAP_THRESHOLD, 1 GiB)``,
   ``mallopt(M_TRIM_THRESHOLD, 1 GiB)``, what the port's CLI runs),
   ``prefault`` (with tpufem's background prefault of the heap pool) and
   ``tpufem`` (the prefault and, on the spoke and from 1M dofs, tpufem's
   detached page warm-up ``warm_vm``: what tpufem/cli.py:116-128 runs);
   the prefault and ``warm_vm`` are copies of tpufem's, kept here.
   Each run's ZZZ stages, wall time and peak RSS are printed, then each
   stage's values by variant.
3. ``/proc/self/statm`` against psutil (where installed): the numbers
   ``--memory_profiling`` logs.

Prints the card's name and power limit (nvidia-smi) where there is one.
"""

from __future__ import annotations

import argparse
import json
import mmap
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_ARGS = ["--problem_type", "poisson", "--mesh_type", "unstructured",
            "--ndofs", "500000", "--scaling_type", "strong", "--dtype",
            "float32", "-ksp_max_it", "120", "--device", "cuda"]
PAGE = 4096


def _touch(m: mmap.mmap) -> float:
    """Seconds to write one byte in every page of ``m``."""
    import numpy as np
    a = np.frombuffer(m, dtype=np.uint8)
    t0 = time.perf_counter()
    a[::PAGE] = 1
    dt = time.perf_counter() - t0
    del a
    return dt


def touch_rates(nbytes: int) -> dict:
    """GB/s of a first touch, a re-touch after munmap and a write
    without faults, in this process."""
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    m = mmap.mmap(-1, nbytes, flags=flags)
    first = _touch(m)
    again = _touch(m)
    m.close()
    m = mmap.mmap(-1, nbytes, flags=flags)
    retouch = _touch(m)
    m.close()
    gb = nbytes / 1e9
    return {"first_touch_gbs": gb / first, "retouch_gbs": gb / retouch,
            "no_fault_gbs": gb / again, "first_s": first,
            "retouch_s": retouch, "no_fault_s": again}


def peak_rss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


# tpufem/hostmem.py's heap prefault and page warm-up, which the port
# does not call (tpufem_torch/hostmem.py keeps tune_allocator alone)
def _touch(nbytes: int) -> None:
    """tpufem/hostmem.py:_touch: one write a page of ``nbytes`` of heap,
    in chunks under the raised mmap threshold, all held to the end."""
    import numpy as np
    chunk = 256 << 20
    held = []
    try:
        for _ in range((nbytes + chunk - 1) // chunk):
            buf = np.empty(chunk, dtype=np.uint8)
            buf[::4096] = 1
            held.append(buf)
    finally:
        held.clear()


def prefault(nbytes: int) -> threading.Thread:
    """tpufem/hostmem.py:prefault(nbytes, background=True)."""
    from tpufem_torch import hostmem
    hostmem.tune_allocator()
    th = threading.Thread(target=_touch, args=(nbytes,), daemon=True)
    th.start()
    return th


_WARM_SRC = r"""
import mmap, os, sys, time
nbytes = int(sys.argv[1])
try:
    os.nice(19)
except OSError:
    pass
chunk = 256 << 20
done = 0
t0 = time.monotonic()
while done < nbytes:
    sz = min(chunk, nbytes - done)
    m = mmap.mmap(-1, sz, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    mv = memoryview(m)
    for off in range(0, sz, 4096):
        mv[off] = 1
    mv.release()
    m.close()  # pages return to the guest allocator, staying warm
    done += sz
sys.stderr.write("[warm_vm] %d MiB in %.1fs\n"
                 % (done >> 20, time.monotonic() - t0))
"""


def warm_vm(nbytes: int) -> subprocess.Popen:
    """tpufem/hostmem.py:warm_vm: ``nbytes`` of pages touched by a nice'd
    subprocess in a session of its own (tpufem never joins it; the
    probe's run joins it before it returns)."""
    return subprocess.Popen(
        [sys.executable, "-c", _WARM_SRC, str(int(nbytes))],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)


VARIANTS = ("plain", "mallopt", "prefault", "tpufem")


def run_cli(variant: str, argv) -> dict:
    """One CLI run in this process with the host-memory ``variant``: its
    ZZZ rows, wall time and peak RSS."""
    sys.path.insert(0, ROOT)
    from tpufem_torch import cli, hostmem
    from tpufem_torch.timing import REGISTRY

    cfg, _ = cli.parse_args(list(argv))
    warm = None
    if variant == "plain":
        hostmem.tune_allocator = lambda: False
    if variant in ("prefault", "tpufem"):
        # tpufem/cli.py:116-128, at the start of the run
        prefault(min(2 << 30, max(256 << 20, 2048 * cfg.ndofs)))
    if variant == "tpufem" and (cfg.ndofs >= 1_000_000
                                or cfg.mesh_type == "unstructured"):
        warm = warm_vm(min(12 << 30, max(4 << 30, 8192 * cfg.ndofs)))
    REGISTRY.reset()
    t0 = time.perf_counter()
    res = cli.main(list(argv))
    wall = time.perf_counter() - t0
    if warm is not None:
        warm.wait()
    return {"variant": variant, "wall_s": wall, "iterations": res.iterations,
            "rows": {name: tot for name, _, tot in REGISTRY.rows()},
            "peak_rss_gb": peak_rss_gb()}


def statm_check() -> str:
    sys.path.insert(0, ROOT)
    from tpufem_torch.memprof import read_statm
    with open("/proc/self/statm") as f:
        raw = f.read().strip()
    vms, rss = read_statm()
    line = (f"/proc/self/statm {raw!r}: VSIZE {vms / 2**30:.3f} GB, RSS "
            f"{rss / 2**30:.3f} GB")
    try:
        import psutil
    except ImportError:
        return line + "; psutil not installed"
    mi = psutil.Process().memory_info()
    return (line + f"; psutil VSIZE {mi.vms / 2**30:.3f} GB, RSS "
            f"{mi.rss / 2**30:.3f} GB")


def _child(args) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                         cwd=ROOT, capture_output=True, text=True)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"hostmem_probe: child {args[:2]} failed "
                         f"({out.returncode})")
    for line in out.stdout.splitlines():
        if line.startswith("HOSTMEM "):
            return json.loads(line[len("HOSTMEM "):])
    raise SystemExit("hostmem_probe: child printed no result")


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no GPU"
    except (OSError, subprocess.SubprocessError):
        return "no GPU"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--gib", type=float, default=2.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--no-cli", action="store_true")
    p.add_argument("--no-touch", action="store_true")
    p.add_argument("--variants", default="plain,mallopt")
    p.add_argument("--json", default="")
    p.add_argument("--child-touch", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--child-cli", choices=VARIANTS, help=argparse.SUPPRESS)
    args, rest = p.parse_known_args()
    rest = [a for a in rest if a != "--"]
    if args.child_touch:
        print("HOSTMEM " + json.dumps(touch_rates(args.child_touch)))
        return 0
    if args.child_cli:
        print("HOSTMEM " + json.dumps(run_cli(args.child_cli,
                                              rest or CLI_ARGS)))
        return 0

    gpu = gpu_line()
    nbytes = int(args.gib * (1 << 30)) // PAGE * PAGE
    print(f"host: {os.cpu_count()} CPUs; card: {gpu}", flush=True)
    out = {"gpu": gpu, "bytes": nbytes, "touch": [], "cli": []}
    print(statm_check(), flush=True)
    for i in range(0 if args.no_touch else 2):
        r = _child(["--child-touch", str(nbytes)])
        out["touch"].append(r)
        print(f"touch process {i + 1}, {nbytes / 2**30:.2f} GiB: first touch "
              f"{r['first_touch_gbs']:.3f} GB/s ({r['first_s']:.3f} s), "
              f"re-touch after munmap {r['retouch_gbs']:.3f} GB/s "
              f"({r['retouch_s']:.3f} s), write without faults "
              f"{r['no_fault_gbs']:.3f} GB/s; first / re-touch "
              f"{r['retouch_s'] and r['first_s'] / r['retouch_s']:.2f}x  "
              f"[{gpu}]", flush=True)
    if not args.no_cli:
        argv = rest or CLI_ARGS
        print("CLI: " + " ".join(argv), flush=True)
        variants = args.variants.split(",")
        for i in range(args.pairs):
            for variant in (variants if i % 2 == 0 else variants[::-1]):
                r = _child(["--child-cli", variant, "--"] + argv)
                out["cli"].append(r)
                print(f"run {len(out['cli'])} ({variant}): wall "
                      f"{r['wall_s']:.3f} s, {r['iterations']} its, peak RSS "
                      f"{r['peak_rss_gb']:.3f} GB; " + ", ".join(
                          f"{k} {v:.3f}" for k, v in r["rows"].items())
                      + f"  [{gpu}]", flush=True)
        for name in list(out["cli"][0]["rows"]) + ["wall"]:
            print(f"{name}: " + " | ".join(
                f"{v} " + " ".join(
                    f"{r['wall_s'] if name == 'wall' else r['rows'].get(name, 0):.3f}"
                    for r in out["cli"] if r["variant"] == v)
                for v in variants) + " s", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
