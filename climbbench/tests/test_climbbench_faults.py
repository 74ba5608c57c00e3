"""``correct`` on the CPU at a tiny size: sound runs of every cell come out
correct (in float32, above the cells' bfloat16, which any sound run
passes); a run in the cell's compute dtype with its timed path broken
underneath (the look for a card skipped, the rest of the run driven) comes
out not correct, once for each fault a cell can have; and the control, the
lower precision in the program's place, fails the limits. One card, so no
cell has an exchange between cards to leave out."""

import json
import math
import subprocess
import sys

import pytest
import torch

from climbbench import program, run
from climbbench.common import HARNESS, Manifest
from climbbench.tests.tiny import overrides, run_cell

TRAIN = ("vilt-b32.train-snlive-b64", "viltbert.train-snlive-b64")
EVAL = ("vilt-b32.eval-snlive-b64",)


def half(batch):
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


@pytest.mark.parametrize("cell", TRAIN + EVAL)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_runs_are_correct(cell, trace):
    rc, result = run_cell(cell, trace=trace, dtype="float32")
    assert rc == 0 and result["correct"], result
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in Manifest(HARNESS.parent).metrics(cell, trace)}
    if trace:
        assert "breakdown" in result and result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_refused(cell, monkeypatch):
    from climb_tpu_torch.train.train_state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, grads: True)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_out_half_the_batch_is_refused(cell, monkeypatch):
    whole = program.train_step

    def halved(model, traffic):
        state, step = whole(model, traffic)
        return state, lambda s, batch: step(s, half(batch))

    monkeypatch.setattr(program, "train_step", halved)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"], result["checks"]


def broken_eval(monkeypatch, fault):
    whole = program.eval_step

    def broken(model, traffic):
        step = whole(model, traffic)
        return lambda batch: (fault(step, batch),) + tuple(step(batch)[1:])

    monkeypatch.setattr(program, "eval_step", broken)


@pytest.mark.parametrize("cell", EVAL)
def test_an_eval_step_that_leaves_out_half_the_batch_is_refused(cell, monkeypatch):
    def fault(step, batch):
        out = step(half(batch))[0]
        return torch.cat([out, out])[:batch["input_ids"].shape[0]]

    broken_eval(monkeypatch, fault)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", EVAL)
def test_an_altered_answer_is_refused(cell, monkeypatch):
    def fault(step, batch):
        out = step(batch)[0].clone()
        out[0] = out[0].roll(1)
        return out

    broken_eval(monkeypatch, fault)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN + EVAL)
def test_the_control_fails_the_limits(cell):
    prepared = run.prepare(["--workload", cell, "--seed", "11", "--seconds", "0"], "cpu",
                           overrides(cell))
    _, _, _, driver, limits, _ = prepared
    numbers = driver.control()
    assert any(not math.isfinite(numbers[k]) or numbers[k] > limits[k]["limit"]
               for k in limits), (numbers, limits)


def test_without_a_card_the_run_exits_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", TRAIN[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and the harness but not the port."""
    (tmp_path / "BENCHMARK.json").write_text((HARNESS.parent / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(HARNESS, tmp_path / "climbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "climbbench/run.py", "--workload", EVAL[0], "--seed",
                          "1", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_the_result_line_is_json_with_checks_last():
    rc, result = run_cell(EVAL[0])
    line = json.dumps(result)
    assert json.loads(line)["checks"]["logit_gap"]["limit"] > 0


@pytest.mark.parametrize("cell", TRAIN + EVAL)
def test_readings_of_faults_in_the_reference_fail_the_limits(cell, monkeypatch, capsys):
    from climbbench import readings

    prepare = run.prepare
    monkeypatch.setattr(run, "prepare",
                        lambda argv: prepare(argv, "cpu", overrides(cell, "float32")))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    assert readings.main(["--workload", cell, "--seeds", "3", "--steps", "4", "--faults", "1",
                          "--int8", "1", "--leaves", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ("int8_port" in row) == (cell in EVAL) and ("program_leaves" in row) == (cell in TRAIN)
    limits = Manifest(HARNESS.parent).limits(cell)
    assert all(row["program"][k] <= limits[k]["limit"] for k in limits), row
    for fault, numbers in row["faults"].items():
        assert any(numbers[k] > limits[k]["limit"] for k in limits), (fault, numbers)
