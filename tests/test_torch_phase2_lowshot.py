"""climb_tpu_torch's Phase II low-shot driver against climb_tpu's on the CPU.

``SyntheticVLDataset.convert_to_low_shot`` and ``SubsetDataset`` keep the JAX
package's indices; every ``low_shot_*`` trainer of the task configs exists.
Both drivers run ``--tiny --synthetic`` from the same upstream task
checkpoints (files written here and read by both) and the same initial
parameters (the JAX driver's, loaded into the port's model, as in
``tests/test_torch_language.py``), with no dropout in the multiple-choice head
of either package: ``singletask_ft`` snli-ve, and ``sequential_ft`` over
snli-ve, nlvr2, vcr, which trains nlvr2 and vcr low-shot from task 0's
checkpoint (the port trains its model in place, so the second must start
from the merged checkpoint again, not from the first's trained weights).
nlvr2 runs 6 epochs and hits its eval epoch 6; vcr runs 1 epoch, below its
first eval epoch 2, and scores its final parameters.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

import climb_tpu.models.vilt as jax_vilt
import climb_tpu.train as jax_train
import climb_tpu.train.trainers as jax_trainers
from climb_tpu.cli.train_lowshot_multimodal import main as jax_main
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.data.synthetic import SubsetDataset as JaxSubset
from climb_tpu.data.synthetic import make_synthetic_vl_dataset as jax_make_synthetic
from climb_tpu_torch.ckpt.checkpoint import partial_load, save_task_checkpoint
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import train_lowshot_multimodal as port
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.synthetic import SubsetDataset, make_synthetic_vl_dataset
from climb_tpu_torch.models.heads import MultiChoiceHead
from climb_tpu_torch.train import trainers as port_trainers
from climb_tpu_torch.train.model_factory import create_cl_model
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores
LR = 2e-3  # raised so that a few steps move the scores
SEQUENCE = "snli-ve,nlvr2,vcr"
RUNS = {
    "singletask": ["--cl_algorithm", "singletask_ft", "--ordered_cl_tasks", "snli-ve",
                   "--task_config_overrides", f"snli-ve.num_epochs=2,snli-ve.lr={LR}"],
    "sequential": ["--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", SEQUENCE,
                   "--task_config_overrides",
                   f"nlvr2.num_epochs=6,nlvr2.lr={LR},vcr.num_epochs=1,vcr.lr={LR}"],
}
# (upstream task, low-shot task) of the sequential run, in the order trained
SEQUENTIAL_PAIRS = [("snli-ve", "nlvr2"), ("snli-ve", "vcr"), ("nlvr2", "vcr")]


def _argv(out_dir, run, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", str(out_dir), "--synthetic", "--tiny",
            "--synthetic_train_size", "16", "--batch_size", "8", "--seed", "5",
            "--output_dir", str(out_dir), *RUNS[run], *extra]


def _experiment(out_dir, run):
    args = port.build_parser().parse_args(_argv(out_dir, run))
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    return out_dir / port.lowshot_experiment_name(args), args


def _write_upstream_checkpoints(out_dir):
    """Task checkpoints of the sequence in the reference torch layout, each
    from its own seed (the JAX package reads these files too)."""
    exp, args = _experiment(out_dir, "sequential")
    for n, task in enumerate(SEQUENCE.split(",")):
        args.seed = 100 + n
        model = create_cl_model(args, task_configs, torch.device("cpu"))
        save_task_checkpoint(str(exp), n, task, model.state_dict())
    return exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers' output directories, and the parameters each low-shot run
    started from in each package, as port state dicts."""
    out = {"jax": tmp_path_factory.mktemp("jax"), "port": tmp_path_factory.mktemp("port")}
    exp = _write_upstream_checkpoints(out["port"])
    shutil.copytree(exp, out["jax"] / exp.name)
    starts = {"jax": [], "port": []}
    evals = []  # (task, best_epoch so far) of each of the port's low-shot evals
    made = {}
    mp = pytest.MonkeyPatch()
    jax_create, port_create = jax_train.create_cl_model, port.create_cl_model
    jax_low_shot, port_low_shot = (jax_trainers.LowShotVLTaskTrainer.train,
                                   port_trainers.LowShotVLTaskTrainer.train)

    def jax_recording(args, configs, **kw):
        model = jax_create(args, configs, **kw)
        made[tuple(args.ordered_cl_tasks)] = jax.tree_util.tree_map(np.asarray, model.params)
        return model

    def port_from_jax(args, configs, device, **kw):
        model = port_create(args, configs, device, **kw)
        _, missing = partial_load(model, state_dict_from_jax(made[tuple(args.ordered_cl_tasks)]))
        assert not missing, missing
        return model

    def jax_start(self, model, *a, **kw):
        tree = jax.tree_util.tree_map(np.asarray, model.params)
        starts["jax"].append((self.task_key, state_dict_from_jax(tree)))
        return jax_low_shot(self, model, *a, **kw)

    def port_start(self, model, *a, **kw):
        starts["port"].append((self.task_key, {k: v.clone() for k, v in
                                               model.state_dict().items()}))
        return port_low_shot(self, model, *a, **kw)

    port_eval = port_trainers.VLTaskTrainer.eval

    def counted_eval(self, model, params=None):
        evals.append((self.task_key, self.best_epoch))
        return port_eval(self, model, params)

    head_for = jax_vilt._head_for
    jit_flax_init(mp)
    share_jax_eval_steps(mp)
    mp.setattr(port_trainers.VLTaskTrainer, "eval", counted_eval)
    mp.setattr(jax_train, "create_cl_model", jax_recording)
    mp.setattr(port, "create_cl_model", port_from_jax)
    mp.setattr(jax_trainers.LowShotVLTaskTrainer, "train", jax_start)
    mp.setattr(port_trainers.LowShotVLTaskTrainer, "train", port_start)
    mp.setattr(jax_vilt, "_head_for", lambda spec, d, dtype: head_for(
        dataclasses.replace(spec, dropout_rate=0.0), d, dtype))
    mp.setattr(MultiChoiceHead, "dropout_rate", 0.0)
    try:
        for run in RUNS:
            jax_main(_argv(out["jax"], run))
            port.main(_argv(out["port"], run, "--device", "cpu"))
    finally:
        mp.undo()
    out["starts"], out["evals"] = starts, evals
    return out


def _records(out_dir, run):
    return json.loads((_experiment(out_dir, run)[0] / "lowshot_results.json").read_text())


@pytest.mark.parametrize("run", list(RUNS))
def test_lowshot_results_match_jax_driver(run, runs):
    ref, got = _records(runs["jax"], run), _records(runs["port"], run)
    assert len(got) == len(ref) == (1 if run == "singletask" else len(SEQUENTIAL_PAIRS))
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert {k: v for k, v in g.items() if k != "best_low_shot_score"} == \
            {k: v for k, v in r.items() if k != "best_low_shot_score"}
        np.testing.assert_allclose(g["best_low_shot_score"], r["best_low_shot_score"],
                                   atol=SCORE_ATOL)
    if run == "sequential":
        assert [(r["upstream_task_key"], r["lowshot_task_key"]) for r in got] == SEQUENTIAL_PAIRS
        assert [r["lowshot_task_num"] for r in got] == [1, 2, 2]


def test_each_low_shot_run_starts_from_the_merged_upstream_checkpoint(runs):
    """The parameters every low-shot run starts from are the JAX driver's: in
    particular vcr from task 0 starts where nlvr2 from task 0 did, not from
    the weights that nlvr2's low-shot run trained."""
    starts = runs["starts"]
    assert [t for t, _ in starts["port"]] == [t for t, _ in starts["jax"]] == \
        ["snli-ve", "nlvr2", "vcr", "vcr"]
    for (task, got), (_, ref) in zip(starts["port"], starts["jax"]):
        assert got.keys() == ref.keys()
        for name in ref:
            assert torch.equal(got[name], ref[name]), (task, name)
    from_task0 = [sd for _, sd in starts["port"][1:3]]
    assert all(torch.equal(from_task0[0][k], from_task0[1][k]) for k in from_task0[0])


def test_low_shot_runs_evaluate_at_their_eval_epochs_only(runs):
    """snli-ve (eval epochs 2, 4, 5; 2 epochs) and nlvr2 (6, 8, 10; 6 epochs)
    evaluate once, at their last epoch; vcr (2, 4, ...; 1 epoch) hits none and
    scores its final parameters once, with no best epoch."""
    assert runs["evals"] == [("snli-ve", -1), ("nlvr2", -1), ("vcr", -1), ("vcr", -1)]


def test_low_shot_configs_and_trainers():
    for task in ("vqa", "nlvr2", "snli-ve", "vcr"):
        ls = task_configs[task]["low_shot_config"]
        assert ls == jax_task_configs[task]["low_shot_config"]
        cls = port_trainers.get_task_trainer_class(ls["trainer"])
        assert issubclass(cls, port_trainers.LowShotVLTaskTrainer)
        assert cls.task_key == task and cls.low_shot


@pytest.mark.parametrize("task,kind", [("vqa", {"percentage": 0.05}),
                                       ("vcr", {"percentage": 0.3}),
                                       ("snli-ve", {"num_shots_per_class": 7}),
                                       ("nlvr2", {"num_shots_per_class": 2048})])
def test_convert_to_low_shot_keeps_the_jax_indices(task, kind):
    args = (task, task_configs[task], "train", 96, 40, (64, 96), 3)
    got = make_synthetic_vl_dataset(*args).convert_to_low_shot(seed=11, **kind)
    ref = jax_make_synthetic(*args).convert_to_low_shot(seed=11, **kind)
    assert isinstance(got, SubsetDataset) and isinstance(ref, JaxSubset)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert len(got) == len(ref)
    for i in (0, len(got) - 1):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_missing_upstream_checkpoint_raises(tmp_path):
    with pytest.raises(AssertionError, match="missing upstream checkpoint for task0_snli-ve"):
        port.main(_argv(tmp_path, "sequential", "--device", "cpu"))


def test_lowshot_driver_runs_with_the_scale_out_flags(tmp_path, caplog):
    """The JAX Phase II drivers parse the scale-out flags and build no mesh;
    the port's run their one-process path too: the same low-shot records as
    without the flags, and one line that names them."""
    flags = ["--use_mesh", "--n_model", "2", "--fsdp", "--sharded_checkpoints",
             "--async_checkpoint"]
    port.main(_argv(tmp_path / "plain", "singletask", "--device", "cpu"))
    with caplog.at_level("WARNING"):
        port.main(_argv(tmp_path / "scaled", "singletask", "--device", "cpu", *flags))
    assert _records(tmp_path / "scaled", "singletask") == _records(tmp_path / "plain",
                                                                    "singletask")
    assert ("these flags change nothing: --n_model 2, --use_mesh True, --fsdp True, "
            "--sharded_checkpoints True, --async_checkpoint True") in caplog.text


def test_lowshot_driver_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.main(_argv(tmp_path, "singletask"))  # --device defaults to cuda
