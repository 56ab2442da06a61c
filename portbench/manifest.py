"""``BENCHMARK.json``: its cells and metrics, found by name, and the rules
its names and units keep."""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(s: str) -> bool:
    return bool(NAME.fullmatch(s))


def valid_unit(s: str) -> bool:
    return bool(UNIT.fullmatch(s))


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(config_name: str, kind: str) -> dict:
    """The limits of the numbers that decide ``correct`` for a traffic
    kind on a configuration."""
    with open(BENCH / "limits" / f"{config_name}.{kind}.json") as f:
        return json.load(f)


def metrics_of(manifest: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of the cell reports: with ``traced`` the
    per-layer ones, else the end-to-end ones; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
