"""apply_roofline.elasticity (%, device trace): the three-component K1's
share of its roofline.  The operator's bound over the device time of the
kernels launched inside the program's own ``cg.apply`` spans (one a CG
step), which the traced stretch of an elasticity cell records with the
port's spans on: calls x the bound of one apply / their device seconds.

The bound is ``apply_roofline``'s (fembench/peaks.py), with the work that
the cell's reference counts for its own matrix
(``reference/elasticity.py: apply_work``: x read once and y written
once, three components a vertex, and 2 nnz).  None where the trace holds
no ``cg.apply`` range."""

from fembench import harness, peaks


def read(record):
    r = (record.get("trace") or {}).get("ranges", {}).get("cg.apply")
    if not r or not r["calls"] or not r["device_s"] > 0:
        return None
    work = getattr(harness.load_module("reference", record["problem_type"]),
                   "apply_work", None)
    if work is None:
        return None
    return 100.0 * r["calls"] * peaks.bound_s(*work(record)) / r["device_s"]
