"""The benchmark's data files, found by name.

Nothing here imports the program: the reference, the generators and the
judge read the same specs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(workload: str) -> dict:
    """A cell's workload, configuration, traffic and query specs."""
    w = load("workloads", workload)
    traffic = load("traffic", w["traffic"])
    names = list(dict.fromkeys(traffic["queries"]))
    return {"name": workload, "workload": w,
            "config": load("configs", w["config"]), "traffic": traffic,
            "queries": {q: load("queries", q) for q in names}}


def benchmark() -> Optional[dict]:
    """``BENCHMARK.json`` at the root of the checkout, if there is one."""
    path = ROOT / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None


def metric_entries(bench: Optional[dict], workload: str,
                   trace: bool) -> List[Dict]:
    """The metrics a run of ``workload`` reports: the cell's end-to-end
    metrics without tracing, its per-layer metrics with it."""
    if bench is None:
        return []
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def feature_counts(qspec: dict) -> List[int]:
    return [len(arm.get("features", ())) for arm in qspec["arms"]]
