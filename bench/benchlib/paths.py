"""Where the benchmark's files are, and the manifest that names them."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json``: cells, configurations and metrics by name."""

    def __init__(self, data: dict, root: Path = ROOT):
        self.data = data
        self.root = root

    @classmethod
    def load(cls, path: Path = MANIFEST) -> "Manifest":
        return cls(load_json(path), path.parent)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_file(self, cell: dict) -> dict:
        return load_json(self.root / self.config(cell["config"])["file"])

    def traffic_file(self, cell: dict) -> dict:
        return load_json(self.root / "bench" / "traffic" / f"{cell['traffic']}.json")

    def metrics(self, cell_name: str, kind: str) -> List[dict]:
        """The cell's metrics of one kind ("end_to_end" or "per_layer"): those
        that list it under "workloads", or, without the key, every cell that
        reports the end-to-end metric a per-layer metric moves."""
        out = []
        e2e = {m["name"] for m in self.metrics(cell_name, "end_to_end")} \
            if kind == "per_layer" else set()
        for m in self.data[kind]:
            if "workloads" in m:
                if cell_name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def limits_file(cell_name: str, bench: Path = BENCH) -> Optional[Dict]:
    """The cell's correctness limits (``bench/limits/<cell>.json``), or None."""
    path = bench / "limits" / f"{cell_name}.json"
    return load_json(path) if path.exists() else None


def metric_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "metrics" / f"{name}.py"


def block_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "blocks" / f"{name}.py"


def reference_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "reference" / f"{name}.py"
