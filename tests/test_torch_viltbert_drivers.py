"""climb_tpu_torch's drivers with ``--encoder_name viltbert`` against climb_tpu's
on the CPU.

The Phase I drivers run ``sequential_ft`` and the houlsby adapter algorithm
over snli-ve then nlvr2 (the set-up of ``tests/test_torch_cl_driver_common.py``:
tiny config, 16 synthetic examples a task, the port starting from the JAX
driver's initialization). The Phase II drivers then start from the port's
``sequential_ft`` checkpoints, which both packages read (the JAX package reads
the reference torch layout): ``predict`` serves nlvr2 from its task
checkpoint, the low-shot driver trains nlvr2 low-shot from snli-ve's, and the
language (piqa, max_len 80, so the ViLT side is reallocated) and vision
(synthetic imagenet) drivers load the snli-ve encoder file. Each JAX driver
runs once; every assertion reads the module's fixture.

Held: results and every task checkpoint's parameters as in the ViLT driver
tests, the same predictions, scores at ``SCORE_ATOL``, the same encoder
loaded by both Phase II drivers from one file, and BERT bit-unchanged by
every port run. A text longer than BERT's 512 positions fails in the JAX
language driver, and raises in the port's.
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import climb_tpu.models.vilt as jax_vilt
import climb_tpu.train.downstream as jax_downstream
from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.cli.train_language import main as jax_language
from climb_tpu.cli.train_lowshot_multimodal import main as jax_lowshot
from climb_tpu.cli.train_vision import main as jax_vision
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import predict as port_predict
from climb_tpu_torch.cli import train_language as port_language
from climb_tpu_torch.cli import train_lowshot_multimodal as port_lowshot
from climb_tpu_torch.cli import train_vision as port_vision
from climb_tpu_torch.models import heads
from test_torch_cl_driver_common import (
    LR,
    assert_parameters_match,
    assert_results_match,
    experiment,
    run_both,
    task_checkpoints,
)
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores
TWO = ["--encoder_name", "viltbert", "--ordered_cl_tasks", "snli-ve,nlvr2"]
RUNS = {
    "sequential_ft": ["--cl_algorithm", "sequential_ft", *TWO],
    "adapter": ["--cl_algorithm", "adapter", "--adapter_method", "vanilla", "--adapter_config",
                "houlsby", "--adapter_reduction_factor", "4", *TWO],
}
UPDATES = 6  # 2 snli-ve and 4 nlvr2 steps


def bert(sd):
    return {k: v for k, v in sd.items() if ".bert." in k or k.startswith("bert.")}


def _phase2_argv(out_dir, ckpt, *flags):
    return ["--encoder_name", "viltbert", "--checkpoint_name", str(ckpt),
            "--pretrained_model_name", "scratch", "--synthetic", "--tiny",
            "--synthetic_train_size", "16", "--batch_size", "8", "--seed", "5",
            "--num_shot", "16", "--subsample_seed", "10", "--output_dir", str(out_dir), *flags]


PHASE2 = {
    "language": (jax_language, port_language,
                 ["--task_name", "piqa", "--task_config_overrides",
                  f"piqa.num_epochs=1,piqa.lr={LR}"]),
    "vision": (jax_vision, port_vision,
               ["--task_name", "imagenet", "--synthetic_vision_labels", "5",
                "--task_config_overrides", f"imagenet.num_epochs=1,imagenet.lr={LR}"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver of both packages, once; the port's starting parameters
    and what its Phase II runs loaded and trained."""
    out = run_both(tmp_path_factory, RUNS)
    out["phase2"] = {}
    mp = pytest.MonkeyPatch()
    jit_flax_init(mp)
    share_jax_eval_steps(mp)
    try:
        _phase2(out, mp)
    finally:
        mp.undo()
    return out


def _phase2(out, mp):
    exp = experiment(out["port"], RUNS["sequential_ft"])
    ckpts = exp / "checkpoints"
    # predict: nlvr2 from its task checkpoint
    common = ["--encoder_name", "viltbert", "--ordered_cl_tasks", "snli-ve,nlvr2",
              "--task_key", "nlvr2", "--checkpoint", str(ckpts / "task1_nlvr2" / "model"),
              "--synthetic", "--tiny", "--synthetic_train_size", "48", "--batch_size", "8",
              "--compute_dtype", "float32", "--seed", "3"]
    for which, main in (("jax", jax_predict), ("port", port_predict.main)):
        d = out[which] / "predict"
        extra = ["--device", "cpu"] if which == "port" else []
        out["phase2"][("predict", which)] = main(
            common + ["--output_dir", str(d), "--output_file", str(d / "nlvr2.json"), *extra])

    # low-shot: both from the port's upstream checkpoints
    lowshot = ["--encoder_name", "viltbert", "--pretrained_model_name", "scratch",
               "--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", "snli-ve,nlvr2",
               "--synthetic", "--tiny", "--synthetic_train_size", "16", "--batch_size", "8",
               "--seed", "5", "--task_config_overrides", f"nlvr2.num_epochs=1,nlvr2.lr={LR}"]
    for which, main in (("jax", jax_lowshot), ("port", port_lowshot.main)):
        d = out[which] / "lowshot"
        shutil.copytree(exp, d / exp.name)
        extra = ["--device", "cpu"] if which == "port" else []
        main(lowshot + ["--climb_data_dir", str(d), "--output_dir", str(d), *extra])
        out["phase2"][("lowshot", which)] = json.loads(
            (d / exp.name / "lowshot_results.json").read_text())

    # language and vision: the snli-ve encoder file; the port's classifier is
    # held to the encoder it loaded, then starts from the JAX driver's params
    encoder = ckpts / "task0_snli-ve" / "encoder"
    mp.setattr(jax_vilt, "MultiChoiceHead",
               functools.partial(jax_vilt.MultiChoiceHead, dropout_rate=0.0))
    mp.setattr(heads.MultiChoiceHead, "dropout_rate", 0.0)
    for name, (jax_main, port_module, flags) in PHASE2.items():
        got = out["phase2"][name] = {}
        jax_train, port_train = jax_downstream.train_downstream, port_module.train_downstream

        def jax_recording(args, module, params, *a, _train=jax_train, **kw):
            got["jax_params"] = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
            return _train(args, module, params, *a, **kw)

        def port_from_jax(args, model, *a, _train=port_train, **kw):
            got["loaded"] = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(got["jax_params"])
            result = _train(args, model, *a, **kw)
            got["best"] = result[3]
            return result

        mp.setattr(jax_downstream, "train_downstream", jax_recording)
        mp.setattr(port_module, "train_downstream", port_from_jax)
        jax_main(_phase2_argv(out["jax"] / name, encoder, *flags))
        got["out"] = port_module.main(
            _phase2_argv(out["port"] / name, encoder, *flags, "--device", "cpu"))


@pytest.mark.parametrize("run", list(RUNS))
def test_phase1_results_match_jax_driver(run, runs):
    assert_results_match(runs, RUNS[run])


@pytest.mark.parametrize("run", list(RUNS))
def test_phase1_task_checkpoints_match_jax_driver(run, runs):
    flags = RUNS[run]
    assert_parameters_match(runs, flags, UPDATES)
    ckpt = task_checkpoints(runs, flags, "port")[0]
    assert any(k.startswith("viltbert.bert.") for k in ckpt)


@pytest.mark.parametrize("run", list(RUNS))
def test_phase1_leaves_bert_unchanged(run, runs):
    """Every task checkpoint holds BERT as initialized, bit for bit, and the
    ViLT side has moved."""
    init = runs["init"][run]
    for ckpt in task_checkpoints(runs, RUNS[run], "port"):
        frozen = bert(init)
        assert frozen and all(torch.equal(ckpt[k], v) for k, v in frozen.items())
        assert any(not torch.equal(ckpt[k], init[k]) for k in ckpt
                   if k.startswith("viltbert.vilt."))


def test_predict_matches_jax(runs):
    ref, got = runs["phase2"][("predict", "jax")], runs["phase2"][("predict", "port")]
    assert got["n_examples"] == ref["n_examples"] == 12
    assert got["predictions"] == ref["predictions"]
    assert got["metric"] == ref["metric"]


def test_lowshot_matches_jax(runs):
    ref, got = runs["phase2"][("lowshot", "jax")], runs["phase2"][("lowshot", "port")]
    assert len(got) == len(ref) == 1
    assert {k: v for k, v in got[0].items() if k != "best_low_shot_score"} == \
        {k: v for k, v in ref[0].items() if k != "best_low_shot_score"}
    np.testing.assert_allclose(got[0]["best_low_shot_score"], ref[0]["best_low_shot_score"],
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("name", list(PHASE2))
def test_phase2_driver_matches_jax(name, runs):
    """The results JSON; the encoder both drivers loaded from the snli-ve file
    (three modality rows: 'nlvr2' is in its path) is the same; BERT comes out
    of training as it went in."""
    got = runs["phase2"][name]
    loaded, ref_params = got["loaded"], got["jax_params"]
    assert loaded.keys() == ref_params.keys()
    enc = [k for k in loaded if k.startswith("viltbert.")]
    assert all(torch.equal(loaded[k], ref_params[k]) for k in enc)
    assert loaded["viltbert.vilt.modality_type_embeddings.weight"].shape[0] == 3
    assert all(torch.equal(got["best"][k], ref_params[k]) for k in bert(ref_params))
    out_fn = Path(got["out"])
    ref = json.loads((runs["jax"] / name / out_fn.name).read_text())
    res = json.loads(out_fn.read_text())
    assert res.keys() == ref.keys()
    (test, dev, epoch), = [v for s in res.values() for v in s.values()]
    (rtest, rdev, repoch), = [v for s in ref.values() for v in s.values()]
    assert epoch == repoch == 1
    np.testing.assert_allclose([test, dev], [rtest, rdev], atol=SCORE_ATOL)


def test_language_text_beyond_bert_positions(tmp_path):
    """max_len 1040 > BERT's 512 position slots: the JAX driver fails at
    initialization; the port raises a ValueError saying why."""
    flags = ["--task_name", "sst2", "--max_len_override", "1040"]
    mp = pytest.MonkeyPatch()
    jit_flax_init(mp)
    try:  # BERT's (1, 512, D) position table meets 1040 tokens
        with pytest.raises(TypeError, match=r"incompatible shapes.*1040, 64.*512, 64"):
            jax_language(_phase2_argv(tmp_path / "jax", "scratch", *flags))
    finally:
        mp.undo()
    with pytest.raises(ValueError, match="512 position slots"):
        port_language.main(_phase2_argv(tmp_path / "port", "scratch", *flags, "--device", "cpu"))
