"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), the configuration its engine adapter
(``engines/<engine>.py``) and plain reference (``reference/<engine>.py``).
A metric is read by ``metrics/<name>.py``, or, where there is none, by
the file of its name's longest dotted prefix (``rtf.hoa64`` by
``metrics/rtf.py``), so one reader serves a metric split by
configuration.  A kernel's device time goes
to the function that ``kernels/<kernel>.json`` names, whose least time is
``rooflines/<function>.py``.  A new cell, mix, metric or kernel is a new
file and an entry here: no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["Bench", "load", "NAME", "UNIT", "BENCH_DIR", "ROOT"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def _name(what: str, value: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise ValueError(f"{what}: {value!r} is not a name")
    return value


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Bench:
    """The manifest, and every file a cell needs, looked up by name under
    ``bench_dir``."""

    def __init__(self, raw: dict, bench_dir: Path = BENCH_DIR):
        self.raw = raw
        self.dir = Path(bench_dir)
        self.cells = {_name("workload", w["name"]): w for w in raw["workloads"]}
        self.configs = {_name("config", c["name"]): c for c in raw["configs"]}
        self.end_to_end = {_name("metric", m["name"]): m
                           for m in raw["end_to_end"]}
        self.per_layer = {_name("metric", m["name"]): m
                          for m in raw["per_layer"]}
        self._mods = {}

    # -- data files ----------------------------------------------------------
    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = self.configs[_name("config", name)]
        cfg = _json(self.dir.parent / entry["file"])
        if cfg.get("name") != name:
            raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, "
                             f"not {name!r}")
        return cfg

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{_name('traffic', name)}.json")

    def kernel_functions(self) -> dict:
        """``{kernel: function}`` from every ``kernels/<kernel>.json``."""
        return {p.stem: _json(p)["function"]
                for p in sorted((self.dir / "kernels").glob("*.json"))}

    # -- code found by name --------------------------------------------------
    def _module(self, package: str, name: str):
        """``<package>/<name>.py``, loaded once."""
        path = self.dir / package / f"{_name(package, name)}.py"
        if path not in self._mods:
            if not path.exists():
                raise FileNotFoundError(path)
            self._mods[path] = _from_file(
                f"cardbench_{package}_{name.replace('.', '_')}", path)
        return self._mods[path]

    def driver(self, name: str):
        return self._module("drivers", name)

    def engine(self, name: str):
        return self._module("engines", name)

    def reference(self, name: str):
        return self._module("reference", name)

    def roofline(self, function: str):
        path = self.dir / "rooflines" / f"{_name('function', function)}.py"
        return self._module("rooflines", function) if path.exists() else None

    def reader(self, metric: str):
        """``metrics/<metric>.py``, else the file of the longest dotted
        prefix of ``metric``: its ``read(ctx)`` gives the value, or
        ``None`` where it finds nothing to read."""
        parts = _name("metric", metric).split(".")
        for n in range(len(parts), 0, -1):
            name = ".".join(parts[:n])
            if (self.dir / "metrics" / f"{name}.py").exists():
                return self._module("metrics", name)
        raise FileNotFoundError(f"no reader for {metric!r} under "
                                f"{self.dir / 'metrics'}")

    # -- which metrics a cell reports ----------------------------------------
    def end_to_end_for(self, cell: str) -> list[dict]:
        return [m for m in self.raw["end_to_end"]
                if cell in m.get("workloads", self.cells)]

    def per_layer_for(self, cell: str) -> list[dict]:
        """The metrics that list ``cell``; one that lists no cells goes to
        every cell that reports the end-to-end metric it moves."""
        e2e = {m["name"] for m in self.end_to_end_for(cell)}
        return [m for m in self.raw["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def _from_file(modname: str, path: Path):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path = ROOT, bench_dir: Path | None = None) -> Bench:
    """The manifest at ``root/BENCHMARK.json``; the harness's files under
    ``bench_dir`` (this directory unless a test points elsewhere)."""
    return Bench(_json(Path(root) / "BENCHMARK.json"),
                 BENCH_DIR if bench_dir is None else Path(bench_dir))
