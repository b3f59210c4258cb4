"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the checkout (the repository's own suite collects only ``tests/``).
Puts ``bench/`` and ``src/`` on the path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
