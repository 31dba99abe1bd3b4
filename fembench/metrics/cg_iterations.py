"""cg_iterations (count, program counter): the iterations that the
solver returned, the mean over the window's solves."""


def read(record):
    its = [s[2] for s in record["solves"] if s[2] >= 0]
    return sum(its) / len(its) if its else None
