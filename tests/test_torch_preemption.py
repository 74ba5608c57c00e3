"""SIGTERM checkpoints and mid-epoch resume of climb_tpu_torch on the CPU
(mirrors ``tests/test_preemption.py``).

The handler is scoped to a train loop and a request that nothing acted on
survives its uninstall; a request mid-epoch saves the full train state with
``steps_into_epoch`` and exits 143, and the rerun of the same command ends on
the uninterrupted run's parameters bit for bit (with buckets too, and for an
experience-replay run, which draws from Python's ``random``); a request that
lands after the last poll ends the driver with 143 at the task boundary.
Requests are made from code (``request_preemption``, or the installed
handler called directly): no real signal is sent inside a test worker.
The JAX driver's train state, preempted mid-epoch or saved at an epoch's
end (``tests/torch_resume_common.py``), resumes in the port's driver along
the JAX driver's own resumed trajectory.
"""

import json
import signal

import numpy as np
import pytest
import torch

import torch_resume_common as resume
from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
from climb_tpu_torch.ckpt import checkpoint
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.train import trainers
from climb_tpu_torch.utils import preemption
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

GUARD = ["--skip_nonfinite_updates", "2"]
# four to six AdamW steps at lr 2e-3 from the same state on reordered float32
# sums; the key bias's gradient is rounding noise in both packages (see
# tests/test_torch_train_step.py), so it is held to the steps' sum
RESUME_ATOL, RESUME_RTOL = 5e-5, 1e-4
SHIFT_INVARIANT = ".k.bias"


@pytest.fixture(autouse=True)
def _clear_flag():
    preemption.clear_preemption()
    yield
    preemption.clear_preemption()


def _argv(out, tasks="snli-ve", algorithm="singletask_ft", *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", str(out), "--synthetic", "--tiny", "--synthetic_train_size",
            "24", "--batch_size", "8", "--seed", "5", "--task_config_overrides",
            "snli-ve.num_epochs=3,snli-ve.lr=2e-3,nlvr2.num_epochs=2,nlvr2.lr=2e-3",
            "--output_dir", str(out), "--ordered_cl_tasks", tasks, "--cl_algorithm",
            algorithm, "--do_train", "--device", "cpu", *extra]


def _experiment(out):
    return next(p for p in out.iterdir() if p.is_dir())


def _preempt_at_step(monkeypatch, n, seen=None):
    """Request a preemption after the n-th train step of the process, as the
    SIGTERM handler would; ``seen`` collects the SIGTERM handler at each step."""
    make = trainers.make_step_dispatcher
    count = [0]

    def hooked(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            count[0] += 1
            if seen is not None:
                seen.append(signal.getsignal(signal.SIGTERM))
            if count[0] == n:
                preemption.request_preemption()
            return out
        return run

    monkeypatch.setattr(trainers, "make_step_dispatcher", hooked)


def test_handler_is_scoped_and_a_pending_request_survives():
    before = signal.getsignal(signal.SIGTERM)
    assert preemption.install_preemption_handler()
    try:
        assert not preemption.preemption_requested()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before
        handler(signal.SIGTERM, None)  # what delivering SIGTERM runs
        assert preemption.preemption_requested()
        assert preemption.install_preemption_handler()  # nested installs stack
        preemption.uninstall_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) is handler
    finally:
        preemption.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is before
    assert preemption.preemption_requested()  # not acted on: it stays pending


def _task_model(out, n=0, task="snli-ve"):
    return checkpoint.load_task_checkpoint(str(_experiment(out)), n, task)


def _assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("buckets,at", [
    ([], 5),  # epoch 2, step 2 of 3
    (["--aspect_buckets", "64,96", "--text_buckets", "auto"], 3),  # epoch 1, step 3 of 5
])
def test_preempted_mid_epoch_resumes_to_identical_params(buckets, at, tmp_path, monkeypatch):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    port.main(_argv(whole, "snli-ve", "singletask_ft", *buckets))
    seen = []
    _preempt_at_step(monkeypatch, at, seen)
    with pytest.raises(SystemExit) as e:
        port.main(_argv(cut, "snli-ve", "singletask_ft", *buckets))
    assert e.value.code == 143
    assert all(h is not signal.SIG_DFL and callable(h) for h in seen)  # installed
    assert not preemption.preemption_requested()  # acted on: cleared
    state = _experiment(cut) / "checkpoints" / "task0_snli-ve" / "train_state"
    meta = torch.load(state, weights_only=True)["meta"]
    loader = trainers.get_task_trainer_class("snli-ve")(
        port.build_parser().parse_args(_argv(cut, "snli-ve", "singletask_ft", *buckets)),
        port.task_configs, {}, torch.device("cpu"), "snli-ve").train_dataloader
    done, epoch = 0, 1  # the epoch of step `at` and the steps before it
    while True:
        loader.set_epoch(epoch)
        if done + len(loader) >= at:
            break
        done, epoch = done + len(loader), epoch + 1
    assert 0 < at - done < len(loader)  # mid-epoch
    assert (meta["epoch"], meta["steps_into_epoch"], meta["global_step"]) == (
        epoch - 1, at - done, at)
    monkeypatch.undo()
    port.main(_argv(cut, "snli-ve", "singletask_ft", *buckets))
    assert not state.exists()
    _assert_same_params(_task_model(whole), _task_model(cut))
    assert json.loads((_experiment(whole) / "results.json").read_text()) == \
        json.loads((_experiment(cut) / "results.json").read_text())


def test_er_run_preempted_and_resumed_is_bit_identical(tmp_path, monkeypatch):
    extra = ["--memory_percentage", "0.2", "--memory_sampling_strategy", "random",
             "--replay_frequency", "2"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    port.main(_argv(whole, "snli-ve,nlvr2", "experience_replay", *extra))
    _preempt_at_step(monkeypatch, 12, None)  # task 1 has 9 steps: mid-task 2
    with pytest.raises(SystemExit) as e:
        port.main(_argv(cut, "snli-ve,nlvr2", "experience_replay", *extra))
    assert e.value.code == 143
    monkeypatch.undo()
    port.main(_argv(cut, "snli-ve,nlvr2", "experience_replay", *extra))
    for n, task in enumerate(("snli-ve", "nlvr2")):
        _assert_same_params(_task_model(whole, n, task), _task_model(cut, n, task))
    assert json.loads((_experiment(whole) / "results.json").read_text()) == \
        json.loads((_experiment(cut) / "results.json").read_text())


def test_driver_exits_143_at_the_task_boundary(tmp_path):
    """A request that no train loop acted on (with --save_state_epochs 0 the
    loop does not poll) ends the driver at the next task boundary; task 1's
    checkpoint and results are on disk and the rerun skips it."""
    out = tmp_path / "exp"
    argv = _argv(out, "snli-ve,nlvr2", "sequential_ft", "--save_state_epochs", "0")
    preemption.request_preemption()
    with pytest.raises(SystemExit) as e:
        port.main(argv)
    assert e.value.code == 143 and not preemption.preemption_requested()
    results = json.loads((_experiment(out) / "results.json").read_text())
    assert [r["task_key"] for r in results] == ["snli-ve"]
    port.main(argv)
    results = json.loads((_experiment(out) / "results.json").read_text())
    assert [r["task_key"] for r in results] == ["snli-ve", "nlvr2"]


def test_no_sigterm_checkpoint_installs_no_handler(tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    _preempt_at_step(monkeypatch, 10 ** 6, seen)
    port.main(_argv(tmp_path, "snli-ve", "singletask_ft", "--no_sigterm_checkpoint"))
    assert seen and all(h is before for h in seen)
    seen.clear()
    port.main(_argv(tmp_path / "b", "snli-ve", "singletask_ft"))  # the default installs one
    assert seen and all(h is not before for h in seen)
    assert signal.getsignal(signal.SIGTERM) is before  # and uninstalls it


@pytest.fixture(scope="module")
def jax_preempted(tmp_path_factory):
    """The preempted JAX run's directory and its four train states."""
    src = tmp_path_factory.mktemp("jax_run")
    return src, resume.jax_train_states(src, *GUARD)


@pytest.mark.parametrize("kind,layout", [("mid", "msgpack"), ("end", "sharded")])
def test_port_resumes_a_jax_train_state_on_its_trajectory(kind, layout, jax_preempted,
                                                          tmp_path, caplog):
    """The port's driver resumes the JAX run from its state (mid-epoch 2, or
    the end of epoch 1; the sharded one under --sharded_checkpoints, as the
    run that wrote it) and the JAX driver from the same state's msgpack file
    (it cannot read its own sharded train state: tests/test_torch_msgpack.py).
    Both resume (only the remaining steps run), each step's loss agrees within
    tests/test_torch_train_driver.py's W&B tolerance, the dev scores and
    results are equal, and the task's final parameters agree within
    ``RESUME_ATOL``/``RESUME_RTOL``. Dropout is off in this run (hidden
    dropout 0, no multiple-choice head): the JAX dropout key cannot carry
    over, and the port's generator, seeded from --seed and the global step,
    draws nothing."""
    from climb_tpu.configs.wandb_config import wandb_config as jax_wandb_config
    from climb_tpu.utils.wandb import wandb_logger as jax_wandb
    from climb_tpu_torch.configs.wandb_config import wandb_config as port_wandb_config
    from climb_tpu_torch.utils.wandb import wandb_logger as port_wandb

    src, states = jax_preempted
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    resume.install(states[kind, "msgpack"], jax_dir, src)
    resume.install(states[kind, layout], port_dir, src)
    history, sharded = {}, ["--sharded_checkpoints"] if layout == "sharded" else []
    with pytest.MonkeyPatch.context() as mp:
        jit_flax_init(mp)
        share_jax_eval_steps(mp)
        for name, config, logger, run in (
                ("jax", jax_wandb_config, jax_wandb,
                 lambda: jax_main(resume.argv(jax_dir, *GUARD, "--do_wandb_logging"))),
                ("port", port_wandb_config, port_wandb,
                 lambda: port.main(resume.argv(port_dir, *GUARD, "--device", "cpu",
                                               "--do_wandb_logging", *sharded)))):
            mp.setitem(config, "log_freq", 1)
            mp.setattr(logger, "is_initialized", False)
            mp.setattr(logger, "_history", [])
            with caplog.at_level("INFO"):
                run()
            history[name] = logger._history
    assert "JAX train state; its dropout key does not carry over" in caplog.text
    done = resume.PREEMPT_AT if kind == "mid" else 3
    losses = {k: [h["snli-ve/loss"] for h in v if "snli-ve/loss" in h]
              for k, v in history.items()}
    assert len(losses["port"]) == len(losses["jax"]) == 9 - done
    assert [list(h) for h in history["port"]] == [list(h) for h in history["jax"]]
    for got, ref in zip(history["port"], history["jax"]):
        for k, v in ref.items():
            if k.endswith("/dev_score"):
                assert got[k] == v
            elif k.endswith("/loss"):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6)
    assert json.loads((port_dir / resume.EXPERIMENT / "results.json").read_text()) == \
        json.loads((jax_dir / resume.EXPERIMENT / "results.json").read_text())
    got, ref = _task_model(port_dir), _task_model(jax_dir)
    assert got.keys() == ref.keys()
    for n in ref:
        atol = 2 * (9 - done) * 2e-3 if n.endswith(SHIFT_INVARIANT) else RESUME_ATOL
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), atol=atol,
                                   rtol=RESUME_RTOL, err_msg=n)
