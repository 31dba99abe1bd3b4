"""The benchmark of tpufem_torch, the PyTorch and CUDA port of tpufem.

One run measures one cell of ``BENCHMARK.json`` once:

    python3 fembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``mixes/<name>.json``); the configuration's problem type names the
build function of the system under test (``problems/<type>.py``) and its plain
reference (``reference/<type>.py``); each metric has a reader of its
own (``metrics/<name>.py``).  The harness finds every one of them by its
name, so a cell, a mix or a metric is added as new files alone.
"""
