"""vcycle_device_ms.elasticity (ms, device trace): the device time of the
kernels launched inside the benchmark's range around each call of the
solver's preconditioner (``fembench.vcycle``) in the traced stretch, the
mean per call.  Beside ``vcycle_ms``, the host wall of the same calls,
it says whether the V-cycle waits on the host or on the card."""


def read(record):
    r = (record.get("trace") or {}).get("ranges", {}).get("fembench.vcycle")
    if not r or not r["calls"] or not r["device_s"] > 0:
        return None
    return 1e3 * r["device_s"] / r["calls"]
