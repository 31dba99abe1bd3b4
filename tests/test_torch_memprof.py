"""``--memory_profiling`` (tpufem_torch.memprof) against tpufem's sampler:
its ``[MEM]`` lines in tpufem's format, read from ``/proc/self/statm``
with no third-party package (the numbers psutil gives), a first sample
that raises in the caller, and no sampler thread left behind by a run,
whether it ends or raises."""

import logging
import re
import threading

import pytest
import torch

from tpufem import memprof as tpu_memprof

from tpufem_torch import cli, memprof
from tpufem_torch.problems import poisson

torch.set_num_threads(1)
MEM_LINE = re.compile(r"^\[MEM\] VSIZE = \d+\.\d{3} GB, RSS = \d+\.\d{3} GB$")


def _samplers():
    return [t for t in threading.enumerate()
            if t.name == "tpufem_torch-memprof"]


def _mem_records(caplog):
    return [r for r in caplog.records
            if r.name == "tpufem_torch" and r.getMessage().startswith("[MEM]")]


def test_cli_logs_mem_lines_in_tpufem_format(caplog):
    """A CLI run logs [MEM] lines from the start of the run to its end,
    with tpufem's format string, and leaves no sampler behind."""
    import inspect
    assert '"[MEM] VSIZE = %.3f GB, RSS = %.3f GB"' in \
        inspect.getsource(tpu_memprof.MemoryProfiler._run)
    with caplog.at_level(logging.INFO, logger="tpufem_torch"):
        res = cli.main(["--ndofs", "3000", "--dtype", "float64",
                        "--device", "cpu", "--memory_profiling"])
    assert res.iterations > 0
    recs = _mem_records(caplog)
    assert recs, "no [MEM] line"
    for r in recs:
        assert r.msg == "[MEM] VSIZE = %.3f GB, RSS = %.3f GB"
        assert MEM_LINE.match(r.getMessage()), r.getMessage()
        vms, rss = (float(v) for v in
                    re.findall(r"\d+\.\d{3}", r.getMessage()))
        assert vms >= rss > 0.0
    assert not _samplers()


def test_without_the_flag_no_mem_line(caplog):
    with caplog.at_level(logging.INFO, logger="tpufem_torch"):
        cli.main(["--ndofs", "3000", "--dtype", "float64", "--device", "cpu"])
    assert not _mem_records(caplog)


def test_statm_agrees_with_psutil():
    """VSIZE and RSS from /proc/self/statm are psutil's memory_info()
    (which reads the same file on Linux) to within a few MB."""
    psutil = pytest.importorskip("psutil")
    proc = psutil.Process()
    vms, rss = memprof.read_statm()
    mi = proc.memory_info()
    assert abs(vms - mi.vms) <= 8 << 20
    assert abs(rss - mi.rss) <= 8 << 20
    assert vms >= rss > 0


def test_start_raises_where_statm_cannot_be_read(tmp_path):
    """The first sample is the caller's: an unreadable file raises from
    start() and no thread is started."""
    prof = memprof.MemoryProfiler(path=str(tmp_path / "no-statm"))
    with pytest.raises(FileNotFoundError):
        prof.start()
    assert prof._thread is None and not _samplers()


def test_sampler_period_and_stop(caplog):
    """Samples every interval until stop(), which joins the thread."""
    with caplog.at_level(logging.INFO, logger="tpufem_torch"):
        prof = memprof.MemoryProfiler(interval_s=0.01).start()
        assert _samplers()
        threading.Event().wait(0.2)
        prof.stop()
    n = len(_mem_records(caplog))
    assert n >= 3
    assert not _samplers()
    threading.Event().wait(0.05)
    assert len(_mem_records(caplog)) == n


def test_no_sampler_survives_a_run_that_raised(monkeypatch, caplog):
    """A run that fails after the sampler started stops it on the way
    out."""
    def boom(*a, **k):
        raise RuntimeError("problem build failed")
    monkeypatch.setattr(poisson, "problem", boom)
    with caplog.at_level(logging.INFO, logger="tpufem_torch"), \
            pytest.raises(RuntimeError, match="problem build failed"):
        cli.main(["--ndofs", "3000", "--device", "cpu",
                  "--memory_profiling"])
    assert _mem_records(caplog)
    assert not _samplers()


def test_device_memory_stats_on_the_cpu_is_empty():
    """JAX's CPU backend reports no memory stats; neither does the
    port's CPU."""
    assert memprof.device_memory_stats(torch.device("cpu")) == {}
