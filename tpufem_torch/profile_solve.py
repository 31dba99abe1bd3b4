"""Op-level profile of the warm, uncertified CG solve.

Runs the CLI once (which builds the problem and its preconditioner), then
times ``--solves`` warm uncertified solves, and profiles one more with
``torch.profiler``.  It prints the wall time of the profiled solve, the
device's busy time (the union of its kernel and copy intervals) and busy
share, the kernel launches per CG iteration, each of the port's CUDA
kernels' launches and device time, and the profiler's op table by device
time.

    python -m tpufem_torch.profile_solve                # 500k f32 GMG, cuda
    python -m tpufem_torch.profile_solve -- --problem_type cgpoisson \\
        --order 3 --ndofs 500000 --scaling_type strong --device cuda \\
        [-use_flat 1]
    python -m tpufem_torch.profile_solve -- --problem_type elasticity \\
        --ndofs 500000 --scaling_type strong -pc_type amg  # brick-AMG
    python -m tpufem_torch.profile_solve -- --problem_type poisson \\
        --order 3 --ndofs 500000 --scaling_type strong     # P2/P3 GMG
    python -m tpufem_torch.profile_solve -- --problem_type elasticity \\
        --order 2 --ndofs 500000 --scaling_type strong     # P2/P3 elasticity
    python -m tpufem_torch.profile_solve -- --problem_type poisson \\
        --mesh_type unstructured --ndofs 150000 --scaling_type strong \\
        -ksp_max_it 120                                   # spoke, SA-AMG
    python -m tpufem_torch.profile_solve -- --ndofs 500000 \\
        --scaling_type strong -pc_type amg -amg_brick off  # cube SA-AMG
    python -m tpufem_torch.profile_solve --solves 10 -- --ndofs 15000 \\
        --dtype float32 --device cpu                    # CPU: no device rows

Everything after ``--`` goes to ``tpufem_torch.cli``.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import List, Optional

import torch

from tpufem_torch import cli

MAIN_PATH = ["--problem_type", "poisson", "--ndofs", "500000",
             "--scaling_type", "strong", "--dtype", "float32",
             "-pc_type", "gmg", "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
             "--device", "cuda"]
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel")
# the port's CUDA kernels, by the name of their device function
PORT_KERNELS = ("stencil_p1_kernel", "stencil_p1_bs3_kernel",
                "stencil_p1_bs3_table_kernel",
                "strip_apply_kernel", "strip_cg_kernel",
                "flat_interior_kernel", "brick_flat_kernel",
                "dia_zones_kernel", "perm_apply_cube_kernel",
                "perm_apply_sum_kernel", "csr_spmv_kernel",
                "dense_gemv_bf16_kernel", "dense_gemv_bf16_combine",
                "matfree_action_clusters_kernel", "matfree_action_halo_kernel",
                "gmg_restrict_kernel", "gmg_prolong_kernel")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time a device
    was busy, from its kernels' and copies' intervals (summing the
    profiler's per-op device times instead counts each kernel under its
    op and again under its own name)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def kernel_device_ms(spans, kernel: str, reps: int,
                     launches: int = 1) -> float:
    """Device ms per call of a port kernel, from a profile of ``reps``
    calls that launch it ``launches`` times each: ``spans`` are the
    profiler's device (name, start us, end us) intervals, of which those
    whose name holds ``kernel`` count.  Their union over ``reps``: other
    kernels in the window (an L2 flush, the caller's own) do not count,
    and a kernel overlapping itself counts once.  A count of the kernel's
    spans other than reps x launches raises ValueError: the profiler
    missed or split launches, and the union would not be the kernel's
    time."""
    own = [(s, e) for name, s, e in spans if kernel in name]
    if len(own) != reps * launches:
        raise ValueError(f"the profiler recorded {len(own)} spans of "
                         f"{kernel!r} over {reps} calls of {launches} "
                         f"launch(es): expected {reps * launches}")
    return busy_us(own) / reps / 1e3


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m tpufem_torch.profile_solve")
    p.add_argument("--solves", type=int, default=10,
                   help="warm uncertified solves to time")
    p.add_argument("cli_args", nargs="*",
                   help="tpufem_torch.cli arguments (after --)")
    args = p.parse_args(argv)
    res = cli.main(args.cli_args or MAIN_PATH)
    prob = res.problem
    solver = prob.solver_function
    on_cuda = prob.b.device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(prob.b.device)

    runs = []
    for _ in range(args.solves):
        sync()
        t0 = time.perf_counter()
        _, its, _ = solver.run(prob.u, prob.b)
        sync()
        runs.append(time.perf_counter() - t0)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        solver.run(prob.u, prob.b)
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    ours = {k: [e for e in kernels if k in e.name] for k in PORT_KERNELS}
    out = dict(
        iterations=its, solves=runs,
        median_s=statistics.median(runs) if runs else None,
        wall_s=wall,
        busy_s=busy_us((e.time_range.start, e.time_range.end)
                       for e in dev) / 1e6,
        launch_calls=sum(e.name in _LAUNCH_CALLS for e in events),
        device_kernels=len(kernels),
        device_copies=len(dev) - len(kernels),
        port_kernels={k: (len(v), sum(e.time_range.elapsed_us() for e in v)
                          / 1e6) for k, v in ours.items()})
    where = (torch.cuda.get_device_name(prob.b.device) if on_cuda
             else "cpu")
    if runs:
        print(f"warm uncertified solve x{len(runs)}: median "
              f"{out['median_s']:.4f} s, min {min(runs):.4f}, max "
              f"{max(runs):.4f}, {its} iterations  [{where}]")
    print(f"profiled warm uncertified solve: wall {wall:.4f} s, device busy "
          f"{out['busy_s']:.4f} s ({100 * out['busy_s'] / wall:.1f}%), "
          f"{out['launch_calls']} launch calls, {out['device_kernels']} "
          f"device kernels ({out['device_kernels'] / max(its, 1):.1f} per "
          f"iteration) + {out['device_copies']} copies/fills  [{where}]")
    for k, (n, s) in out["port_kernels"].items():
        if n:
            print(f"  {k}: {n} launches, {1e3 * s:.3f} ms device")
    sort = "self_cuda_time_total" if on_cuda else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=25))
    return out


if __name__ == "__main__":
    main()
