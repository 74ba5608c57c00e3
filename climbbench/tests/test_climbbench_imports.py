"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Modules are compared by their
top-level name, whole: ``climb_tpu_torch`` begins with ``climb_tpu`` and is
not the JAX package."""

import ast
import json
import subprocess
import sys

import pytest

from climbbench.common import HARNESS

ROOT = HARNESS.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "climb_tpu"}
PORT = "climb_tpu_torch"


def loaded(code):
    """Top-level names of the modules a fresh interpreter holds after
    running ``code`` from the repository's root."""
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = loaded(
        "from climbbench import run, readings, measure, program, trace, traffic, weights\n"
        "from climbbench.common import Manifest\n"
        "Manifest(run.ROOT).resolve_all()")
    assert PORT in names
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_port():
    names = loaded("from climbbench.reference import model, params, train")
    assert not names & (BANNED | {PORT}), names & (BANNED | {PORT})


@pytest.mark.parametrize("path", sorted(HARNESS.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    """A source scan besides: no import statement of the harness names JAX
    or the JAX package, and none of the reference names the port."""
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            imported.add(node.module.split(".")[0])
    if path.parent.name == "tests":
        return  # the tests hold the reference against the port, and may import both
    assert not imported & BANNED, path
    if path.parent.name == "reference":
        assert PORT not in imported, path


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from climbbench import run

    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.banned_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "climb_tpu_torch.x", object())
    assert "climb_tpu" not in run.banned_modules()
