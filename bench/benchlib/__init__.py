"""The benchmark harness of ``repro_torch`` (one cell, one run, one line).

Everything that belongs to one configuration, traffic mix, metric or cell
lives in a file of its own under ``bench/`` and is found by name from
``BENCHMARK.json``; this package is the code that reads them.  Nothing here
imports the JAX package or JAX, and nothing imports ``repro_torch`` at
module import time, so the CPU tests import every module on any machine.
"""
