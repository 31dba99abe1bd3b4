"""setup_s (s, host clock): from the process's start to the first solve
of the window: the kernel library's build or load, the mesh, the
problem, the pool of right-hand sides and the warm-up solves."""


def read(record):
    return record["setup_s"]
