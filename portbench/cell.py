"""A cell of ``BENCHMARK.json`` and the files it names, found by name: its
configuration (the ``file`` of its ``configs`` entry), its traffic mix
(``mixes/<traffic>.json``), its limits (``limits/<workload>.json``), its
task (``tasks/<task>.py``, the configuration's ``task``) and its per-layer
readers (``metrics/<metric>.py``). Adding a cell, a mix, a configuration or
a metric adds files; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    base: Path          # the benchmark's folder the cell's files are in
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def task(self) -> ModuleType:
        return load_module(self.base / "tasks" / f"{self.config['task']}.py")

    def readers(self) -> dict[str, tuple[dict, ModuleType]]:
        return {m["name"]: (m, load_module(self.base / "metrics" / f"{m['name']}.py"))
                for m in self.per_layer}


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark's folders by file path (a name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not there")
    name = f"portbench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for(entries: list[dict], workload: str) -> list[dict]:
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read from
    ``root`` and the benchmark's folder under it."""
    base = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((base / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    return Cell(workload, base, int(w["chips"]), config, mix, limits,
                _for(bench["end_to_end"], workload), _for(bench["per_layer"], workload))
