"""Finds what ``BENCHMARK.json`` names, by name, in files of their own:

- ``configs/<config>.json``: the configuration as run (its ``config``
  holds every field of the program's ``SpairConfig``), its source, what was
  ``reduced`` and what was ``assumed``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of one
  ``kind`` of driver (``drivers/<kind>.py``) and the configuration fields
  the mix sets (``overrides``: the batch, the compute dtype);
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell, with the readings it was set from;
- ``layer_metrics/<metric>.py``: one reader per per-layer metric,
  ``read(record) -> float or None``.

A new cell, mix, configuration or metric is a new file and a new entry in
the manifest; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path = ROOT, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else HERE
        self.manifest = json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def _json(self, folder: str, name: str) -> Dict:
        return json.loads((self.bench / folder / f"{name}.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"perfbench: no workload {name!r} in "
                         "BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)["limits"]

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict]:
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str):
        path = self.bench / "layer_metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_layer_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    @staticmethod
    def driver(kind: str):
        return importlib.import_module(f"perfbench.drivers.{kind}")
