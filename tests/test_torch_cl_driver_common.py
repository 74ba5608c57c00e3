"""Shared set-up of the ``test_torch_cl_drivers*.py`` files (no tests here).

Both Phase I drivers run ``--tiny --synthetic`` on 16 examples a task, batch
8, one epoch a task, at a learning rate raised so that one epoch moves the
scores. The port starts from the JAX driver's initialization of the same
seed (its first model's tree, adapters included, loaded by
``state_dict_from_jax``), and the multiple-choice head's dropout is 0 in
both packages, so that the two runs take the same steps.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import climb_tpu.models.vilt as jax_vilt
import climb_tpu.train as jax_train
from climb_tpu.ckpt.checkpoint import load_params as jax_load_params
from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
from climb_tpu_torch.ckpt.checkpoint import load_task_checkpoint
from climb_tpu_torch.ckpt.convert import partial_load, state_dict_from_jax
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.models.heads import MultiChoiceHead
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

LR = 2e-3
OVERRIDES = ",".join(f"{t}.lr={LR},{t}.num_epochs=1" for t in ("snli-ve", "nlvr2", "vqa", "vcr"))
SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores
# Per element, f32 sums in another order over a dozen AdamW steps
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
# AdamW's update is about sign(g) * lr per element while its moments are
# young (and always on a replay step, whose optimizer is fresh). Where g is
# rounding noise in both packages -- the key biases and the multiple-choice
# head's bias, whose exact gradients are 0 (softmax shift invariance), and
# the odd element of a weight whose gradient is ~0 -- the two may move an
# element by lr in opposite directions on every update. So every element is
# held to 2 lr per update, and at most this share of all elements may exceed
# the f32 tolerance.
NOISE_SHARE = 0.01


def argv(out_dir, flags, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", str(out_dir), "--synthetic", "--tiny",
            "--synthetic_train_size", "16", "--batch_size", "8", "--seed", "5",
            "--task_config_overrides", OVERRIDES, "--output_dir", str(out_dir),
            "--do_train", "--do_eval", *flags, *extra]


def tasks_of(flags):
    return flags[flags.index("--ordered_cl_tasks") + 1].split(",")


def start_from_jax(mp):
    """Port models start from the JAX driver's initialization; no dropout in
    the multiple-choice head of either package. The JAX side's ``init`` is
    jitted and its eval steps are shared (``test_torch_data_common.py``)."""
    jit_flax_init(mp)
    share_jax_eval_steps(mp)
    made = {}
    jax_create, port_create = jax_train.create_cl_model, port.create_cl_model

    def jax_recording(args, configs, **kw):
        model = jax_create(args, configs, **kw)
        made[tuple(args.ordered_cl_tasks)] = jax.tree_util.tree_map(np.asarray, model.params)
        return model

    def port_from_jax(args, configs, device, **kw):
        model = port_create(args, configs, device, **kw)
        loaded, missing = partial_load(model, state_dict_from_jax(made[tuple(args.ordered_cl_tasks)]))
        assert not missing, missing
        return model

    head_for = jax_vilt._head_for
    mp.setattr(jax_train, "create_cl_model", jax_recording)
    mp.setattr(port, "create_cl_model", port_from_jax)
    mp.setattr(jax_vilt, "_head_for", lambda spec, d, dtype: head_for(
        dataclasses.replace(spec, dropout_rate=0.0), d, dtype))
    mp.setattr(MultiChoiceHead, "dropout_rate", 0.0)
    return made


def run_both(tmp_path_factory, runs):
    """Both drivers for each run: {"jax": dir, "port": dir, "init": {run: tree}}."""
    mp = pytest.MonkeyPatch()
    made = start_from_jax(mp)
    out = {"jax": tmp_path_factory.mktemp("jax"), "port": tmp_path_factory.mktemp("port"),
           "init": {}}
    try:
        for name, flags in runs.items():
            jax_main(argv(out["jax"], flags))
            port.main(argv(out["port"], flags, "--device", "cpu"))
            out["init"][name] = state_dict_from_jax(made[tuple(tasks_of(flags))])
    finally:
        mp.undo()
    return out


def experiment(out_dir, flags):
    args = port.build_parser().parse_args(argv(out_dir, flags))
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    return out_dir / port.experiment_name_for(args)


def assert_results_match(runs, flags):
    ref_dir, got_dir = experiment(runs["jax"], flags), experiment(runs["port"], flags)
    ref = json.loads((ref_dir / "results.json").read_text())
    got = json.loads((got_dir / "results.json").read_text())
    assert [(r["task_key"], r["best_epoch"]) for r in got] == \
        [(r["task_key"], r["best_epoch"]) for r in ref]
    np.testing.assert_allclose([r["best_score"] for r in got], [r["best_score"] for r in ref],
                               atol=SCORE_ATOL)
    ev_ref = json.loads((ref_dir / "eval_results.json").read_text())
    ev = json.loads((got_dir / "eval_results.json").read_text())
    assert ev.keys() == ev_ref.keys() and ev["forgetting"].keys() == ev_ref["forgetting"].keys()
    for later, by_prev in ev_ref["forgetting"].items():
        for prev, f_ref in by_prev.items():
            np.testing.assert_allclose(ev["forgetting"][later][prev]["absolute_transfer_score"],
                                       f_ref["absolute_transfer_score"], atol=SCORE_ATOL)


def task_checkpoints(runs, flags, which):
    """Each task's checkpoint of one package, as port state dicts."""
    exp = experiment(runs[which], flags)
    out = []
    for n, task in enumerate(tasks_of(flags)):
        if which == "port":
            out.append(load_task_checkpoint(str(exp), n, task))
        else:
            tree = jax_load_params(str(exp / "checkpoints" / f"task{n}_{task}" / "model"))
            out.append(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree)))
    return out


def assert_parameters_match(runs, flags, n_updates):
    """Every task checkpoint of the port against the JAX driver's (see
    NOISE_SHARE for the tolerance)."""
    for ref, got in zip(task_checkpoints(runs, flags, "jax"), task_checkpoints(runs, flags, "port")):
        assert set(got) == set(ref)
        beyond, total = 0, 0
        for name, r in ref.items():
            diff = (got[name] - r).abs()
            assert float(diff.max()) <= 2 * LR * n_updates, name
            beyond += int((diff > PARAM_ATOL + PARAM_RTOL * r.abs()).sum())
            total += r.numel()
        assert beyond <= NOISE_SHARE * total, (beyond, total)


def changed(a: dict, b: dict):
    """Names whose tensors differ between two state dicts."""
    return sorted(k for k in a if not torch.equal(a[k], b[k]))
