"""Run one cell of the benchmark once and print its result line.

    python3 fembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See fembench/harness.py for what a run does.

Python's compiled modules, torch's among them, are cached inside the
checkout at ``.fembench_cache/pycache``, also where the environment asks
Python to write none (``PYTHONDONTWRITEBYTECODE``): the first run of a
checkout compiles them, and every later run loads them.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.pycache_prefix = str(ROOT / ".fembench_cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))

from fembench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
