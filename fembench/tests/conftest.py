"""Settings of the benchmark's own tests (``python -m pytest fembench/tests``).

Tests marked ``cuda`` run the benchmark at a cell's own size on the card
and skip, deciding inside the test, where there is none."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
