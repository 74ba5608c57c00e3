"""climb_tpu_torch's Phase I driver against the JAX driver on the CPU: EWC,
experience replay and feature distillation over snli-ve then nlvr2.

Both drivers run each algorithm from the same initialization
(``test_torch_cl_driver_common.py``); their ``results.json`` and
``eval_results.json`` must agree, and so must every task checkpoint's
parameters. Also: an experience-replay run cut after an epoch of its second
task resumes, with Python's ``random`` state restored, to the same final
parameters as the whole run.
"""

import itertools
import os

import pytest
import torch

from test_torch_cl_driver_common import (
    OVERRIDES,
    argv,
    assert_parameters_match,
    assert_results_match,
    experiment,
    run_both,
)
from climb_tpu_torch.ckpt import checkpoint
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.train import trainers

torch.set_num_threads(1)

TWO = ["--ordered_cl_tasks", "snli-ve,nlvr2"]
RUNS = {
    "ewc": ["--cl_algorithm", "ewc", "--ewc_fisher_sample_percentage", "0.5",
            "--ewc_loss_weight", "100", *TWO],
    "experience_replay": ["--cl_algorithm", "experience_replay", "--memory_percentage", "0.5",
                          "--memory_sampling_strategy", "random", "--replay_frequency", "1",
                          *TWO],
    "feature_distill": ["--cl_algorithm", "feature_distill", "--distill_loss_weight", "10",
                        *TWO],
}
# optimizer updates a run takes: 2 snli-ve and 4 nlvr2 steps, and with
# --replay_frequency 1 a replay step after each nlvr2 step
UPDATES = {"ewc": 6, "experience_replay": 10, "feature_distill": 6}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, RUNS)


@pytest.mark.parametrize("run", list(RUNS))
def test_results_match_jax_driver(run, runs):
    assert_results_match(runs, RUNS[run])


@pytest.mark.parametrize("run", list(RUNS))
def test_task_checkpoints_match_jax_driver(run, runs):
    assert_parameters_match(runs, RUNS[run], UPDATES[run])


def test_experience_replay_resume_gives_the_same_parameters(tmp_path, monkeypatch):
    # a buffer of 12 of snli-ve's 16 examples, so each replay batch of 8 is a
    # draw that the restored random state must repeat; two nlvr2 epochs
    flags = RUNS["experience_replay"] + ["--memory_percentage", "0.75",
                                         "--task_config_overrides",
                                         OVERRIDES + ",nlvr2.num_epochs=2"]
    run = lambda out: port.main(argv(out, flags, "--device", "cpu"))
    # every eval scores higher than the one before, so each task checkpoint
    # holds the parameters after its last epoch
    scores = itertools.count()
    monkeypatch.setattr(trainers.VLTaskTrainer, "eval",
                        lambda self, model, params=None: float(next(scores)))
    run(tmp_path / "whole")

    class Cut(Exception):
        pass

    save = trainers.save_train_state

    def save_then_cut(state, meta, path):  # dies after nlvr2's first epoch is saved
        save(state, meta, path)
        if path.endswith(os.path.join("task1_nlvr2", "train_state")) and meta["epoch"] == 1:
            raise Cut()

    monkeypatch.setattr(trainers, "save_train_state", save_then_cut)
    with pytest.raises(Cut):
        run(tmp_path / "cut")
    monkeypatch.setattr(trainers, "save_train_state", save)
    run(tmp_path / "cut")
    whole, cut = experiment(tmp_path / "whole", flags), experiment(tmp_path / "cut", flags)
    a = checkpoint.load_task_checkpoint(str(whole), 1, "nlvr2")
    b = checkpoint.load_task_checkpoint(str(cut), 1, "nlvr2")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
