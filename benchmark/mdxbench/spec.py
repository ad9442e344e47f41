"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the kind of call the mix names (its ``entry``)
``entries/<entry>.py`` and each of its metrics ``metrics/<name>.py``, all
under the benchmark's folder.  A new configuration, mix, entry kind or
metric is a new file there (and a new entry in ``BENCHMARK.json``);
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path = HERE

    @property
    def windowed(self) -> bool:
        """Whether the call applies the stored VOI window: the mix asks
        for it and the configuration stores one."""
        return bool(self.traffic.get("apply_window")
                    and self.config.get("window_center") is not None)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(spec_path: Path, workload: str, root: Path = HERE) -> Cell:
    """The cell ``workload`` of the spec at ``spec_path``; files are looked
    up under ``root``.  Raises KeyError for an unknown workload."""
    spec = json.loads(Path(spec_path).read_text())
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in {spec_path}")
    cfg = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads(
        (root / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=cfg, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        root=Path(root))


def _module(folder: str, name: str, root: Path):
    path = Path(root) / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"mdxbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = HERE):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    return _module("metrics", name, root).read


def entry(cell):
    """The module ``entries/<entry>.py`` of the cell's traffic mix: the
    pool (``pool``), the calls' targets in turn and at warm-up
    (``targets``, ``warmup``), one call (``call``), the answers
    (``answer``, ``reference``, ``extra`` files for the sample) and the
    spans of a traced run (``SPANS``, ``SYNCED``)."""
    return _module("entries", cell.traffic["entry"], cell.root)
