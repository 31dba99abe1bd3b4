"""device_idle (%, device trace): 1 - the device's busy time over the
wall of the same solves.  The busy time is the union of the device's
kernel and copy intervals in the profiled stretch; the wall is that of
the same solves, the same right-hand sides in the same order, run just
before without the profiler (the harness's ``_timed``), so that the
profiler's own host cost does not count as idle."""


def read(record):
    t, timed = record.get("trace"), record.get("timed")
    if not t or not timed or not timed["wall_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / timed["wall_s"])
