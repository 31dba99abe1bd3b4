"""vcycle_ms (ms, host clock): the host wall of each call of the solver's
preconditioner (the V-cycle), the mean per call, timed on the host's
clock around each call in the traced run's stretch without the profiler
(the harness's ``_timed``)."""


def read(record):
    r = (record.get("timed") or {}).get("ranges", {}).get("fembench.vcycle")
    if not r or not r["calls"]:
        return None
    return 1e3 * r["host_s"] / r["calls"]
