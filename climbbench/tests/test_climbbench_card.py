"""The benchmark on the card: every cell runs from a fresh process and comes
out correct, and on each cell the control (the lower precision in the
program's place) fails the limits, at the cell's own size. Marked ``card``:
skipped without one. On the card:

    python -m pytest climbbench/tests -m card -p no:cacheprovider
"""

import json
import math
import subprocess
import sys

import pytest

from climbbench.common import HARNESS, Manifest

ROOT = HARNESS.parent
CELLS = [c["name"] for c in Manifest(ROOT).data["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "climbbench/run.py", "--workload", cell, "--seed",
                          "2200000017", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "climbbench/readings.py", "--workload", cell,
                          "--seeds", "2200000019,2200000023,2200000029", "--steps", "16",
                          "--control", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = Manifest(ROOT).limits(cell)
    for line in out.stdout.strip().splitlines():
        row = json.loads(line)
        assert any(not math.isfinite(row["control"][k]) or row["control"][k] > limits[k]["limit"]
                   for k in limits), row
