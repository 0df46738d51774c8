"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own, found by its name, so a later change
adds a cell by adding files and entries and edits none:

- ``perfbench/configs/<config>.json``: the estimator and its parameters;
- ``perfbench/traffic/<traffic>.json``: the rows' generator and its
  parameters;
- ``perfbench/workloads/<cell>.json``: the cell's overrides of the
  configuration (each under the key that says why) and the limits of the
  numbers that decide ``correct``;
- ``perfbench/data/<generator>.py``: ``make(params, seed)``;
- ``perfbench/estimators/<estimator>.py``: how a fit of that estimator is
  built, watched and judged;
- ``perfbench/metrics/<metric>.py``: ``read(ctx)``, the metric's value or
  None where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path``, imported by its path (a metric's name
    may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"perfbench: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and files."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"perfbench: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(self.root / "perfbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.spec = load_json(self.root / "perfbench" / "workloads" / f"{name}.json")
        self.chips = int(self.entry["chips"])

    def params(self) -> dict:
        """The estimator's parameters: the configuration's, then the cell's
        overrides (those its deployment's source sets, then those the port
        needs to run it)."""
        out = dict(self.config["params"])
        for key in ("from_source", "for_the_port"):
            out.update(self.spec.get(key, {}))
        return out

    def estimator(self):
        name = self.config["estimator"]
        return load_module(self.root / "perfbench" / "estimators" / f"{name}.py", name)

    def data(self, seed: int):
        gen = self.traffic["generator"]
        module = load_module(self.root / "perfbench" / "data" / f"{gen}.py", gen)
        return module.make(self.traffic["params"], seed)

    def metrics(self, trace: bool) -> list:
        """The (entry, reader) of each metric this cell reports: the
        end-to-end ones untraced, the per-layer ones traced."""
        group = self.bench["per_layer"] if trace else self.bench["end_to_end"]
        out = []
        for m in group:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            reader = load_module(self.root / "perfbench" / "metrics" / f"{m['name']}.py", m["name"])
            out.append((m, reader))
        return out

    def limits(self) -> dict:
        return dict(self.spec.get("limits", {}))
