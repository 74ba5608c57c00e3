"""climb_tpu_torch.cli.train_upstream_continual_learning against the JAX
driver on the CPU.

Both drivers run ``--tiny --synthetic`` singletask_ft on snli-ve and
sequential_ft on snli-ve then nlvr2, for two epochs a task at a learning
rate raised so that the scores move between epochs. The port starts from
the JAX initialization of the same seed (set here, in the test, by loading
the JAX tree into the port's model), and its results.json must then agree
with the JAX driver's. Also: climb_tpu's ``load_params`` reads the port's
task checkpoint and scores the same; a rerun skips finished tasks; a run cut
after an epoch resumes to the same final parameters; unported paths raise.
The CL algorithms and VQA/VCR training have their own files,
``tests/test_torch_cl_*.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from climb_tpu.ckpt.checkpoint import load_params as jax_load_params
from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.train_step import make_eval_step as jax_make_eval_step
from climb_tpu_torch.ckpt import checkpoint
from climb_tpu_torch.ckpt.convert import partial_load, state_dict_from_jax
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.train import trainers
from test_torch_data_common import jit_flax_init, share_jax_eval_steps, shape_only_flax_init

torch.set_num_threads(1)

RUNS = {
    "singletask": ["--cl_algorithm", "singletask_ft", "--ordered_cl_tasks", "snli-ve"],
    "sequential": ["--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", "snli-ve,nlvr2"],
}
EXPERIMENTS = {"singletask": "vilt-singletask_ft-task0_snli-ve",
               "sequential": "vilt-sequential_ft-task0_snli-ve-task1_nlvr2"}
SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores


def _argv(out_dir, run, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", str(out_dir), "--synthetic", "--tiny",
            "--synthetic_train_size", "16", "--batch_size", "8", "--seed", "5",
            "--task_config_overrides",
            "snli-ve.num_epochs=2,snli-ve.lr=2e-3,nlvr2.num_epochs=2,nlvr2.lr=2e-3",
            "--output_dir", str(out_dir), "--do_train", *RUNS[run], *extra]


def _start_from_jax(monkeypatch):
    """Port models start from the JAX driver's initialization of the same
    seed: the JAX driver's initial parameters are kept as it makes them, and
    the port's next model of the same tasks loads them."""
    import climb_tpu.train as jax_train

    made = {}
    jax_create, port_create = jax_train.create_cl_model, port.create_cl_model

    def jax_recording(args, configs, **kw):
        model = jax_create(args, configs, **kw)
        made[tuple(args.ordered_cl_tasks)] = jax.tree_util.tree_map(np.asarray, model.params)
        return model

    def port_from_jax(args, configs, device, **kw):
        model = port_create(args, configs, device, **kw)
        partial_load(model, state_dict_from_jax(made[tuple(args.ordered_cl_tasks)]))
        return model

    monkeypatch.setattr(jax_train, "create_cl_model", jax_recording)
    monkeypatch.setattr(port, "create_cl_model", port_from_jax)


def _results(out_dir, run):
    return json.loads((out_dir / EXPERIMENTS[run] / "results.json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers' output directories after both runs, and each run's W&B
    history in both packages (``--do_wandb_logging``, every step logged; the
    module-global loggers start each run empty and are reset afterwards)."""
    from climb_tpu.configs.wandb_config import wandb_config as jax_wandb_config
    from climb_tpu.utils.wandb import wandb_logger as jax_wandb
    from climb_tpu_torch.configs.wandb_config import wandb_config as port_wandb_config
    from climb_tpu_torch.utils.wandb import wandb_logger as port_wandb

    mp = pytest.MonkeyPatch()
    _start_from_jax(mp)
    jit_flax_init(mp)
    share_jax_eval_steps(mp)
    mp.setitem(jax_wandb_config, "log_freq", 1)
    mp.setitem(port_wandb_config, "log_freq", 1)
    out = {"jax": tmp_path_factory.mktemp("jax"), "port": tmp_path_factory.mktemp("port"),
           "wandb": {}}
    try:
        for run in RUNS:
            for logger in (jax_wandb, port_wandb):
                mp.setattr(logger, "is_initialized", False)
                mp.setattr(logger, "_history", [])
            jax_main(_argv(out["jax"], run, "--do_eval", "--do_wandb_logging"))
            port.main(_argv(out["port"], run, "--do_eval", "--device", "cpu",
                            "--do_wandb_logging"))
            out["wandb"][run] = (jax_wandb._history, port_wandb._history)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_results_match_jax_driver(run, runs):
    ref, got = _results(runs["jax"], run), _results(runs["port"], run)
    assert [(r["task_key"], r["best_epoch"]) for r in got] == \
        [(r["task_key"], r["best_epoch"]) for r in ref]
    np.testing.assert_allclose([r["best_score"] for r in got], [r["best_score"] for r in ref],
                               atol=SCORE_ATOL)
    ev_ref = json.loads((runs["jax"] / EXPERIMENTS[run] / "eval_results.json").read_text())
    ev = json.loads((runs["port"] / EXPERIMENTS[run] / "eval_results.json").read_text())
    assert ev.keys() == ev_ref.keys()
    if run == "sequential":
        f, f_ref = ev["forgetting"]["nlvr2"]["snli-ve"], ev_ref["forgetting"]["nlvr2"]["snli-ve"]
        np.testing.assert_allclose(f["absolute_transfer_score"],
                                   f_ref["absolute_transfer_score"], atol=SCORE_ATOL)
        # the singletask run in the same output_dir gives the transfer gain
        assert ev["upstream_knowledge_transfer"]["snli-ve"]["singletask_score"] is not None


@pytest.mark.parametrize("run", list(RUNS))
def test_wandb_history_matches_jax(run, runs):
    """The same dicts at the same points (JAX trainers.py:491-503, 546): each
    step's loss and ex/s, each epoch's dev score; the losses within the f32
    trajectory's rounding (it grows over the run's twelve AdamW steps at lr
    2e-3: 4.7e-5 relative at the sequential run's worst step), the dev scores
    equal, the ex/s (host clocks) not compared."""
    ref, got = runs["wandb"][run]
    n_tasks = len(RUNS[run][3].split(","))
    assert sum(k.endswith("/dev_score") for h in ref for k in h) == 2 * n_tasks  # 2 epochs
    assert [list(h) for h in got] == [list(h) for h in ref]
    for h, r in zip(got, ref):
        for k, v in r.items():
            if k.endswith("/dev_score"):
                np.testing.assert_allclose(h[k], v, atol=SCORE_ATOL)
            elif k.endswith("/loss"):
                np.testing.assert_allclose(h[k], v, rtol=1e-4, atol=1e-6)


def test_jax_loads_port_checkpoint_with_the_same_score(runs):
    """climb_tpu's load_params reads the port's task0 model file, and its eval
    step scores the snli-ve eval split as the port's results.json says."""
    from climb_tpu.data.collation import stack_collate as jax_collate
    from climb_tpu.data.loader import DataLoader as JaxLoader

    exp = runs["port"] / EXPERIMENTS["singletask"]
    params = jax_load_params(str(exp / "checkpoints" / "task0_snli-ve" / "model"))
    args = port.build_parser().parse_args(_argv(exp, "singletask"))
    args.ordered_cl_tasks = ["snli-ve"]
    args.image_height, args.image_width = 64, 96
    with pytest.MonkeyPatch.context() as mp:  # the parameters come from the checkpoint
        shape_only_flax_init(mp)
        model = jax_create_cl_model(args, jax_task_configs)
    step = jax_make_eval_step(model.module, "snli-ve", "ce")
    trainer = trainers.VLTaskTrainer(args, port.task_configs, {}, torch.device("cpu"), "snli-ve")
    total = count = 0.0
    for batch in JaxLoader(trainer.eval_dataset, 8, jax_collate, num_workers=1):
        _, s, c = step(params, batch)
        total, count = total + float(s), count + float(c)
    assert 100.0 * total / count == _results(runs["port"], "singletask")[0]["best_score"]


def test_rerun_skips_finished_tasks(runs, monkeypatch):
    def no_training(self, model, **cl):
        raise AssertionError("a finished task was trained again")

    monkeypatch.setattr(trainers.VLTaskTrainer, "train", no_training)
    before = _results(runs["port"], "sequential")
    port.main(_argv(runs["port"], "sequential", "--device", "cpu"))
    assert _results(runs["port"], "sequential") == before


def test_elastic_resume_gives_the_same_parameters(tmp_path, monkeypatch):
    argv = lambda out: _argv(out, "singletask", "--device", "cpu")
    port.main(argv(tmp_path / "whole"))

    class Cut(Exception):
        pass

    save = trainers.save_train_state

    def save_then_cut(*a, **kw):  # the run dies right after epoch 1's state is saved
        save(*a, **kw)
        raise Cut()

    monkeypatch.setattr(trainers, "save_train_state", save_then_cut)
    with pytest.raises(Cut):
        port.main(argv(tmp_path / "cut"))
    monkeypatch.setattr(trainers, "save_train_state", save)
    exp = EXPERIMENTS["singletask"]
    state_file = tmp_path / "cut" / exp / "checkpoints" / "task0_snli-ve" / "train_state"
    assert state_file.exists()
    port.main(argv(tmp_path / "cut"))
    assert not state_file.exists()  # the task checkpoint supersedes it
    whole = checkpoint.load_task_checkpoint(str(tmp_path / "whole" / exp), 0, "snli-ve")
    resumed = checkpoint.load_task_checkpoint(str(tmp_path / "cut" / exp), 0, "snli-ve")
    assert set(whole) == set(resumed)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k
    assert _results(tmp_path / "whole", "singletask") == _results(tmp_path / "cut", "singletask")


def test_device_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.main(_argv(tmp_path, "singletask"))  # --device defaults to cuda


@pytest.mark.parametrize("flags", [
    # the flags that raised "not ported" before the last slice now run (their
    # outputs: tests/test_torch_tools.py)
    ["--scan_unroll", "2"],
    ["--profile_dir", "{tmp}/trace"],
    ["--memory_profile", "{tmp}/mem.pickle"],
    ["--do_wandb_logging"],
])
def test_unported_paths_raise(flags, tmp_path, monkeypatch):
    """Each flag runs the Phase I driver to its results. The run has four
    steps: under the profile window's start and the memory snapshot's step
    (5), so neither writes, as in the JAX trainer; on the CPU the memory
    snapshot only warns. W&B keeps its in-memory history (no wandb package)."""
    from climb_tpu_torch.utils.wandb import wandb_logger

    monkeypatch.setattr(wandb_logger, "is_initialized", False)
    monkeypatch.setattr(wandb_logger, "_history", [])
    flags = [f.format(tmp=tmp_path) for f in flags]
    port.main(_argv(tmp_path, "singletask", "--device", "cpu") + flags)
    assert len(_results(tmp_path, "singletask")) == 1
    assert not (tmp_path / "trace").exists() and not (tmp_path / "mem.pickle").exists()
    assert wandb_logger.is_initialized == (flags == ["--do_wandb_logging"])
    if wandb_logger.is_initialized:
        assert [list(h) for h in wandb_logger._history] == [["snli-ve/dev_score"]] * 2


@pytest.mark.parametrize("flags", [
    ["--use_mesh"],
    ["--async_checkpoint"],
    ["--pp_stages", "2"],
    ["--sharded_checkpoints"],
    ["--fsdp"],
])
def test_scale_out_flags_run_in_one_process(flags, tmp_path):
    """Without a torchrun world the scale-out flags run the plain path (JAX's
    one-device guard); a sharded task checkpoint is then written whole by the
    one rank. Their multi-rank paths: tests/test_torch_parallel_*.py and
    tests/test_torch_sharded_ckpt.py."""
    port.main(_argv(tmp_path, "singletask", "--device", "cpu") + flags)
    exp = next(p for p in tmp_path.iterdir() if p.is_dir())
    model = exp / "checkpoints" / "task0_snli-ve" / "model"
    assert model.is_dir() == (flags == ["--sharded_checkpoints"]) and model.exists()
    assert len(json.loads((exp / "results.json").read_text())) == 1


def test_msgpack_checkpoint_raises(tmp_path):
    """The JAX package's msgpack task checkpoints and elastic train states are
    read (tests/test_torch_msgpack.py); a msgpack train state without
    optax's state raises, naming what it lacks."""
    from flax import serialization

    from climb_tpu_torch.train.optimizer import make_optimizer
    from climb_tpu_torch.train.train_state import TrainState

    path = tmp_path / "train_state"
    path.write_bytes(serialization.msgpack_serialize(
        {"state": {"step": np.asarray(3)}, "meta": {"epoch": np.asarray(1)}}))
    layer = torch.nn.Linear(2, 2)
    state = TrainState(dict(layer.named_parameters()),
                       make_optimizer(["weight", "bias"], lr=1e-3, total_steps=4))
    with pytest.raises(ValueError, match="JAX train_state: no opt_state"):
        checkpoint.load_train_state(state, str(path))
