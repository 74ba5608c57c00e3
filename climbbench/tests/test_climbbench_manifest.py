"""The harness is driven by data: every name in ``BENCHMARK.json``
resolves to its file, a cell, configuration and metric added as new files
and entries are picked up with no file edited, an unknown name fails with a
message that names it, and the manifest keeps its format's rules."""

import hashlib
import json
import shutil

import pytest

from climbbench.common import HARNESS, Manifest, ManifestError, check_name, check_unit

ROOT = HARNESS.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_resolves():
    Manifest(ROOT).resolve_all()


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "climbbench").rglob("*") if p.is_file()}


def test_new_files_and_entries_are_picked_up(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HARNESS, tmp_path / "climbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    h = tmp_path / "climbbench"
    (h / "configs" / "vilt-b32-copy.json").write_text((h / "configs" / "vilt-b32.json").read_text())
    traffic = json.loads((h / "traffic" / "eval-snlive-b64.json").read_text())
    (h / "traffic" / "eval-snlive-b32.json").write_text(json.dumps({**traffic, "batch": 32}))
    (h / "limits" / "vilt-b32-copy.eval-snlive-b32.json").write_text(
        (h / "limits" / "vilt-b32.eval-snlive-b64.json").read_text())
    (h / "metrics" / "examples_per_step.eval.py").write_text(
        "def read(r):\n    return r.examples_per_step\n")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({**data["configs"][0], "name": "vilt-b32-copy",
                            "file": "climbbench/configs/vilt-b32-copy.json"})
    data["workloads"].append({"name": "vilt-b32-copy.eval-snlive-b32", "config": "vilt-b32-copy",
                              "traffic": "eval-snlive-b32", "chips": 1, "why": "a new cell"})
    data["per_layer"].append({"name": "examples_per_step.eval", "unit": "examples",
                              "better": "higher", "source": "program_counter", "layer": "Device",
                              "moves": "eval_ex_per_s",
                              "workloads": ["vilt-b32-copy.eval-snlive-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    manifest = Manifest(tmp_path)
    manifest.resolve_all()
    cell = manifest.cell("vilt-b32-copy.eval-snlive-b32")
    assert manifest.traffic(cell["traffic"])["batch"] == 32
    assert manifest.config(cell["config"])["hidden_size"] == 768
    assert [m["name"] for m in manifest.metrics(cell["name"], True)] == ["examples_per_step.eval"]
    reading = type("R", (), {"examples_per_step": 32})
    assert manifest.reader("examples_per_step.eval").read(reading) == 32
    after = digests(tmp_path)
    assert all(after[p] == d for p, d in before.items()), "an existing file changed"


@pytest.mark.parametrize("lookup, name", [
    (lambda m: m.cell("vilt-b32.no-such-traffic"), "vilt-b32.no-such-traffic"),
    (lambda m: m.config("no-such-config"), "no-such-config"),
    (lambda m: m.traffic("no-such-traffic"), "no-such-traffic"),
    (lambda m: m.reader("no_such_metric"), "no_such_metric"),
    (lambda m: m.driver("no_such_kind"), "no_such_kind"),
    (lambda m: m.limits("no-such-cell"), "no-such-cell"),
])
def test_an_unknown_name_fails_naming_it(lookup, name):
    with pytest.raises(ManifestError, match=name):
        lookup(Manifest(ROOT))


@pytest.mark.parametrize("bad", ["", "a b", "a/b", ".hidden", "-x", "a,b", "μs", "x" * 65])
def test_names_keep_to_the_allowed_characters(bad):
    with pytest.raises(ManifestError):
        check_name(bad, "test")


def test_every_name_and_unit_of_the_manifest_is_allowed():
    names = [c["name"] for c in MANIFEST["configs"]]
    for c in MANIFEST["workloads"]:
        names += [c["name"], c["config"], c["traffic"]]
    for c in MANIFEST["configs"]:
        names += c["reduced"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        names.append(m["name"])
        check_unit(m["unit"], m["name"])
    for n in names:
        check_name(n, "manifest")


KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_the_manifest_keeps_its_rules():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    for section, keys in KEYS.items():
        for entry in MANIFEST[section]:
            assert set(entry) <= keys, entry
            assert entry.get("better", "lower") in ("lower", "higher")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = [c["name"] for c in MANIFEST["workloads"]]
    for cell in cells:
        reported = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2, cell
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"]), cell
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells)), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert all(c["chips"] == 1 for c in MANIFEST["workloads"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024
