"""What every part of the harness shares: the manifest (``BENCHMARK.json``),
the files it names, seeds and the names' rules.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration and a
traffic mix. The harness finds everything else by name, so a later change
adds a cell, a configuration or a metric as new files and entries alone:

- ``climbbench/traffic/<traffic>.json``: the mix (its ``kind`` selects
  ``climbbench/drivers/<kind>.py``);
- the configuration's ``file`` in the manifest: its sizes and port flags;
- ``climbbench/limits/<cell>.json``: the limit of each number ``correct``
  compares, with the readings it was set from;
- ``climbbench/metrics/<metric>.py``: one reader a metric.
"""

import hashlib
import importlib.util
import json
import re
from pathlib import Path

HARNESS = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class ManifestError(ValueError):
    """A name that resolves to nothing, or breaks the manifest's rules."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def check_name(name, what):
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ManifestError(f"{what} {name!r}: a name is 1-64 of A-Z a-z 0-9 _ . -, "
                            f"not starting with . or -")
    return name


def check_unit(unit, what):
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ManifestError(f"{what}: unit {unit!r} is 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _named(path, what, name):
    if not path.is_file():
        raise ManifestError(f"{what} {name!r}: no file {path.relative_to(HARNESS.parent)}")
    return path


class Manifest:
    """``BENCHMARK.json`` and the files its names resolve to."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise ManifestError(f"no BENCHMARK.json in {self.root}")
        self.data = load_json(path)
        self.harness = self.root / "climbbench"

    def cell(self, name):
        cells = {c["name"]: c for c in self.data["workloads"]}
        if name not in cells:
            raise ManifestError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        return cells[name]

    def config(self, name):
        configs = {c["name"]: c for c in self.data["configs"]}
        if name not in configs:
            raise ManifestError(f"unknown config {name!r}; BENCHMARK.json has {sorted(configs)}")
        entry = configs[name]
        return load_json(_named(self.root / entry["file"], "config", name))

    def traffic(self, name):
        check_name(name, "traffic")
        return load_json(_named(self.harness / "traffic" / f"{name}.json", "traffic", name))

    def limits(self, cell):
        return load_json(_named(self.harness / "limits" / f"{cell}.json", "limits of", cell))

    def driver(self, kind):
        check_name(kind, "traffic kind")
        return load_module(_named(self.harness / "drivers" / f"{kind}.py", "driver", kind))

    def reader(self, metric):
        check_name(metric, "metric")
        return load_module(_named(self.harness / "metrics" / f"{metric}.py", "metric", metric))

    def metrics(self, cell, traced):
        """The entries of the metrics a run of ``cell`` reports: the
        end-to-end ones untraced, the per-layer ones traced."""
        entries = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def resolve_all(self):
        """Every cell, configuration, traffic mix, limit file and metric
        reader, loaded once; raises on the first name that resolves to
        nothing or breaks the rules."""
        for c in self.data["configs"]:
            check_name(c["name"], "config")
            self.config(c["name"])
        for c in self.data["workloads"]:
            for key in ("name", "config", "traffic"):
                check_name(c[key], f"workload {key}")
            self.config(c["config"])
            self.driver(self.traffic(c["traffic"])["kind"])
            self.limits(c["name"])
        for m in self.data["end_to_end"] + self.data["per_layer"]:
            check_name(m["name"], "metric")
            check_unit(m["unit"], m["name"])
            self.reader(m["name"])


def load_module(path):
    """A Python file of the harness as a module (metric and driver files
    have dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "climbbench_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def derive_seed(seed, stream):
    """A 63-bit seed of its own for each stream drawn from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
