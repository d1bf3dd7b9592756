"""Finding a cell, its configuration, its adapter and the per-layer
metrics by name, in the benchmark's own folders:

* ``workloads/<cell>.json``: the cell's configuration, chips, traffic
  parameters and why it exists;
* ``configs/<config>.json``: the configuration as it is run, its source,
  and the files of its adapter (what drives the program) and its plain
  reference;
* ``metrics/<metric>.py``: one reader per per-layer metric.

A later cell, configuration or metric is new files, and nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(base: Path, kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = base / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    with open(path) as f:
        data = json.load(f)
    data["name"] = name
    return data


def workload(name: str, base: Path = BENCH) -> dict:
    return _json(base, "workloads", name)


def config(name: str, base: Path = BENCH) -> dict:
    return _json(base, "configs", name)


def load_module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adapter(cfg: dict, base: Path = BENCH):
    return load_module(base / cfg["adapter"], "portbench_adapter_" + re.sub(r"\W", "_", cfg["name"]))


def metric_names(base: Path = BENCH) -> list:
    return sorted(p.stem for p in (base / "metrics").glob("*.py") if NAME.match(p.stem))


def metric(name: str, base: Path = BENCH):
    return load_module(base / "metrics" / f"{name}.py", "portbench_metric_" + re.sub(r"\W", "_", name))
