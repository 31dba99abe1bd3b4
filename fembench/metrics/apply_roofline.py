"""apply_roofline (%, device trace): the operator's bound over the device
time of the kernels launched inside the benchmark's range around each
call of the solver's action, in the traced stretch.

The bound of one apply is the same work whatever implements it:
max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) (fembench/peaks.py),
with the bytes and operations that the reference of the cell's problem
type counts for its own matrix (``reference/<type>.py: apply_work``):
for the P1 cube, x read once and y written once, and 2 nnz.  Against the
H100's published peaks at 700 W: the card's power limit is printed
beside it."""

from fembench import harness, peaks


def read(record):
    r = (record.get("trace") or {}).get("ranges", {}).get("fembench.apply")
    if not r or not r["calls"] or not r["device_s"] > 0:
        return None
    work = getattr(harness.load_module("reference", record["problem_type"]),
                   "apply_work", None)
    if work is None:
        return None
    return 100.0 * r["calls"] * peaks.bound_s(*work(record)) / r["device_s"]
