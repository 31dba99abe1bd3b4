"""smooth_l0_share.elasticity (%, device trace): the device time of the
kernels launched inside the program's ``gmg.smooth.L0`` spans (the fine
level's pre- and post-smoothing) over that inside the benchmark's
``fembench.vcycle`` range, in the traced stretch: how much of a V-cycle
the fine three-component smoothing is.  None where either range is
absent."""


def read(record):
    ranges = (record.get("trace") or {}).get("ranges", {})
    vc, l0 = ranges.get("fembench.vcycle"), ranges.get("gmg.smooth.L0")
    if not vc or not l0 or not l0["calls"] or not vc["device_s"] > 0:
        return None
    return 100.0 * l0["device_s"] / vc["device_s"]
