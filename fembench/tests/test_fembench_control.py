"""The control of ``correct``: the plain reference put in the program's
place, computed in TF32 (the precision below the configurations' float32
with TF32 off), has to come out not correct; the same reference in
float32 and the program itself have to come out correct.  The reference
has no multigrid, so in the GMG cell both reference subjects are judged
by the numbers other than ``its``, the iterations that measure the
program's preconditioner; they fail ``its`` itself by hundreds of
iterations.

On the CPU at a lattice a test holds; marked ``cuda``, at the cells' own
size on the card, three seeds (``fembench/control.py`` prints the
readings the limits were set from)."""

import pytest
import torch

from fembench import control, harness
from fembench.tests.helpers import CPU, need_cuda, small_cell

CELLS = ("cgpoisson_p1_cube.10m", "poisson_p1_cube_gmg.10m")
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def readings(monkeypatch, workload, subject, seeds, device, small):
    if small:
        monkeypatch.setattr(harness, "cell",
                            lambda spec, w: small_cell(w))
    return control.readings(workload, list(seeds), subject, device)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("subject, correct", [
    ("tf32", False), ("float32", True), ("program", True)])
def test_control_on_a_small_lattice(monkeypatch, workload, subject, correct):
    for r in readings(monkeypatch, workload, subject, SEEDS[:1], CPU, True):
        if subject == "program":
            assert r["correct"] is correct, r
            continue
        assert judged_without_its(r) is correct, r
        if "its" in r["checks"]:
            assert r["checks"]["its"] > 3 * r["limits"]["its"], r


def judged_without_its(r) -> bool:
    return all(v <= r["limits"][k] for k, v in r["checks"].items()
               if k != "its")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(monkeypatch, workload):
    need_cuda()
    dev = torch.device("cuda", 0)
    for r in readings(monkeypatch, workload, "tf32", SEEDS, dev, False):
        assert r["correct"] is False, r
        assert judged_without_its(r) is False, r
