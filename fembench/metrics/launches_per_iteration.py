"""launches_per_iteration (count, device trace): the device kernels in the
traced stretch over the CG iterations its solves returned."""


def read(record):
    t = record.get("trace")
    if not t or not record.get("trace_iterations") or not t["kernels"]:
        return None
    return t["kernels"] / record["trace_iterations"]
