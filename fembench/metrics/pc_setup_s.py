"""pc_setup_s (s, program span): the preconditioner's set-up, the port's
timing registry's "ZZZ PC setup" (run inside the first solve)."""


def read(record):
    return record["registry"].get("ZZZ PC setup")
