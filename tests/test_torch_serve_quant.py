"""climb_tpu_torch.ops.quant and the int8 dense routing against climb_tpu on the CPU.

The int8 quantizers and the int32 accumulator of the integer product must be
bit-equal to JAX's; the float rescale within float32 rounding. On the tiny
learner (one JAX tree through ``state_dict_from_jax``), ``dense_impl`` 'int8'
and 'int8_static' (with JAX's calibrated scales carried across by
``ckpt.convert.quant_from_jax``) give JAX's logits at the tolerance of
tests/test_torch_port_model.py in float32 and its argmax in bfloat16; the
port's calibration gives JAX's scales; BERT's dense layers take the int8
path; and train mode ignores ``dense_impl``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltConfig as JaxViltConfig
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.models.bert import BertConfig as JaxBertConfig
from climb_tpu.models.bert import BertCore as JaxBertCore
from climb_tpu.ops import quant as jax_quant
from climb_tpu.train.train_step import calibrate_quant_scales as jax_calibrate
from climb_tpu.train.train_step import make_eval_step as jax_eval_step
from climb_tpu_torch.ckpt.convert import quant_from_jax, quant_to_jax, state_dict_from_jax
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.models.bert import BertConfig, BertCore
from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.ops import quant
from climb_tpu_torch.train import eval_step
from test_torch_port_model import TINY, _batch, _randomize

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4  # tests/test_torch_port_model.py
TASKS = ("nlvr2", "snli-ve", "vcr")
DUMMY = {"input_ids": jnp.zeros((2, 40), jnp.int32), "text_mask": jnp.ones((2, 40), jnp.float32),
         "pixel_values": jnp.zeros((2, 64, 96, 3), jnp.float32),
         "patch_hw": jnp.ones((2, 2), jnp.int32)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tree():
    module = JaxLearner(JaxViltConfig(**TINY), jax_head_specs(TASKS, jax_task_configs))
    params = jax.jit(lambda key: module.init(key, DUMMY, method=JaxLearner.init_all))(
        jax.random.PRNGKey(0))["params"]
    return _randomize(jax.tree_util.tree_map(np.asarray, params), seed=1)


def _models(tree, **kw):
    jmodule = JaxLearner(JaxViltConfig(**TINY, **kw), jax_head_specs(TASKS, jax_task_configs))
    port = ViltContinualLearner(ViltConfig(**TINY, **kw),
                                head_specs_from_task_configs(TASKS, task_configs))
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    return jmodule, port.eval()


def _labelled(task, seed=0):
    b = _batch(task, seed)
    b["labels"] = np.zeros(b["input_ids"].shape[0], np.int32)
    return b


def test_quantizers_bit_equal():
    rng = np.random.RandomState(0)
    w = (rng.randn(48, 64) * 0.05).astype(np.float32)  # (in, out), JAX's kernel
    w[3, 5] = 0.0
    jq, js = jax_quant.quantize_per_channel(jnp.asarray(w))
    q, s = quant.quantize_per_channel(_t(w.T.copy()))  # (out, in), torch's weight
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    a = (rng.randn(3, 7, 48) * 2.0).astype(np.float32)
    a[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    a[1, 2, :4] = [0.5, -0.5, 1.5, 2.5]  # halves round to even, as jnp.round
    jaq, jsa = jax_quant.quantize_per_row(jnp.asarray(a))
    aq, sa = quant.quantize_per_row(_t(a))
    np.testing.assert_array_equal(aq.numpy(), np.asarray(jaq))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    assert aq.dtype == torch.int8 and q.dtype == torch.int8


def test_int32_accumulator_bit_equal():
    rng = np.random.RandomState(1)
    aq = rng.randint(-127, 128, (37, 768)).astype(np.int8)
    wq = rng.randint(-127, 128, (768, 3072)).astype(np.int8)
    ref = jax.lax.dot_general(jnp.asarray(aq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    acc = quant.int_mm(_t(aq), _t(wq.T.copy()).t())  # the (out, in) weight's transpose
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["dynamic", "static", "prequant"])
def test_int8_dense_matches_jax(kind):
    rng = np.random.RandomState(2)
    a = rng.randn(4, 9, 64).astype(np.float32)
    w = (rng.randn(64, 40) * 0.05).astype(np.float32)
    b = (rng.randn(40) * 0.1).astype(np.float32)
    ja, jw, jb = map(jnp.asarray, (a, w, b))
    ta, tw, tb = _t(a), _t(w.T.copy()), _t(b)
    if kind == "dynamic":
        ref, out = jax_quant.int8_dense(ja, jw, jb), quant.int8_dense(ta, tw, tb)
    elif kind == "static":
        amax = np.float32(np.abs(a).max() * 0.8)  # some activations clip
        ref = jax_quant.int8_dense_static(ja, jw, jb, jnp.asarray(amax))
        out = quant.int8_dense_static(ta, tw, tb, _t(amax))
    else:
        jaq, jsa = jax_quant.quantize_per_row(ja)
        ref = jax_quant.int8_dense_prequant(jaq, jsa, jw, jb, jnp.float32)
        aq, sa = quant.quantize_per_row(ta)
        out = quant.int8_dense_prequant(aq, sa, tw, tb, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 64, 64), (17, 60, 64), (17, 64, 100)])
def test_int_mm_rule_raises(shape):
    """torch._int_mm's rule on the card: more than 16 rows, K and N multiples
    of 8 (the CPU product has no such rule)."""
    with pytest.raises(ValueError, match="more than 16 rows"):
        quant.check_int_mm(*shape)
    quant.check_int_mm(17, 64, 64)


def _static_logits(jmodule, port, tree, task, batch, qcol):
    """Both sides' float32 logits with the JAX scales ``qcol`` given to their
    eval steps (JAX's ``extra_vars``, the port's ``quant_scales``)."""
    ref = jax_eval_step(jmodule, task, "ce", extra_vars={"quant": qcol})(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    scales = quant_from_jax(jax.tree_util.tree_map(np.asarray, qcol))
    out = eval_step.make_eval_step(port, task, "ce", quant_scales=scales)(
        {k: _t(v) for k, v in batch.items()})[0]
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mlp_impl", ["xla", "pallas"])
@pytest.mark.parametrize("dense_impl", ["int8", "int8_static"])
@pytest.mark.parametrize("task", TASKS)
def test_learner_logits_match_jax(tree, task, dense_impl, mlp_impl):
    """float32 logits of the int8 forwards; int8_static with JAX's calibrated
    scales carried across. mlp_impl 'pallas' keeps the FFN float, as in JAX.

    A static scale can put an activation exactly on a rounding tie (x.5 steps
    of its scale), where a 1-ulp float32 difference upstream (LayerNorm and
    attention sum in another order) moves its int8 code by one. Where the
    logits miss, the miss must be in one example and vanish when both sides'
    scales move by 1e-4 of themselves, which moves every tie; a wrong
    routing or rescale would not vanish."""
    jmodule, port = _models(tree, dense_impl=dense_impl, mlp_impl=mlp_impl)
    batch = _labelled(task)
    if dense_impl == "int8":
        ref = jax_eval_step(jmodule, task, "ce")(tree, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})[0]
        out = eval_step.make_eval_step(port, task, "ce")({k: _t(v) for k, v in batch.items()})[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        return
    qcol = jax_calibrate(jmodule, task, tree, [{k: jnp.asarray(v) for k, v in
                                                 _labelled(task, seed=5).items()}])
    out, ref = _static_logits(jmodule, port, tree, task, batch, qcol)
    missed = ~np.isclose(out, ref, atol=ATOL, rtol=RTOL)
    if missed.any():
        assert missed.any(-1).sum() == 1, np.abs(out - ref).max(-1)
        nudged = jax.tree_util.tree_map(lambda x: x * np.float32(1 + 1e-4), qcol)
        out, ref = _static_logits(jmodule, port, tree, task, batch, nudged)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_calibrated_scales_match_jax(tree):
    """The port's calibration records JAX's scales under JAX's names: the patch
    projection's (max |pixel|) bit for bit, the rest at float32 rounding
    (LayerNorm sums run in another order); ``quant_to_jax`` restacks them."""
    jmodule, port = _models(tree, dense_impl="int8_static")
    batches = [_labelled("snli-ve", seed=s) for s in (3, 4)]
    qcol = jax_calibrate(jmodule, "snli-ve", tree,
                         [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    ref = quant_from_jax(jax.tree_util.tree_map(np.asarray, qcol))
    got = eval_step.calibrate_quant_scales(port, "snli-ve",
                                           [{k: _t(v) for k, v in b.items()} for b in batches])
    assert sorted(got) == sorted(ref)
    assert len(got) == 6 * TINY["num_layers"] + 1
    assert float(got["vilt.patch_projection_amax"]) == float(ref["vilt.patch_projection_amax"])
    for name in ref:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=1e-6, err_msg=name)
    back = quant_to_jax(ref)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, qcol))


@pytest.mark.parametrize("dense_impl", ["int8", "int8_static"])
def test_bf16_argmax_matches_jax(tree, dense_impl):
    jmodule, port = _models(tree, dense_impl=dense_impl, dtype="bfloat16")
    rng = np.random.RandomState(6)
    batch = {"input_ids": rng.randint(1, 100, (16, 40)).astype(np.int32),
             "text_mask": np.ones((16, 40), np.float32),
             "pixel_values": rng.randint(0, 256, (16, 64, 96, 3)).astype(np.uint8),
             "patch_hw": np.tile([[2, 3]], (16, 1)).astype(np.int32),
             "labels": np.zeros(16, np.int32)}
    extra = None
    if dense_impl == "int8_static":
        qcol = jax_calibrate(jmodule, "snli-ve", tree, [{k: jnp.asarray(v) for k, v in
                                                          batch.items()}], jnp.bfloat16)
        extra = {"quant": qcol}
        quant.load_quant_buffers(port, quant_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             qcol)))
    ref = jax_eval_step(jmodule, "snli-ve", "ce", jnp.bfloat16, extra_vars=extra)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    out = eval_step.make_eval_step(port, "snli-ve", "ce", torch.bfloat16)(
        {k: _t(v) for k, v in batch.items()})[0]
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy().argmax(-1), ref.argmax(-1))


def test_bert_core_int8_matches_jax():
    """ViLT-BERT's BERT quantizes its dense layers too (JAX bert.py:54-62)."""
    cfg = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    rng = np.random.RandomState(7)
    ids = rng.randint(1, 100, (3, 12)).astype(np.int32)
    mask = (np.arange(12) < np.array([[12], [7], [3]])).astype(np.float32)
    jcore = JaxBertCore(JaxBertConfig(**cfg, dense_impl="int8"))
    params = jax.jit(jcore.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    tree = _randomize(jax.tree_util.tree_map(np.asarray, params["params"]), seed=8)
    ref = jax.jit(jcore.apply)({"params": tree}, jnp.asarray(ids), jnp.asarray(mask))
    port = BertCore(BertConfig(**cfg, dense_impl="int8"))
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    float_core = BertCore(BertConfig(**cfg))
    float_core.load_state_dict(state_dict_from_jax(tree), strict=True)
    with torch.no_grad():
        out = port(_t(ids), _t(mask))
        plain = float_core(_t(ids), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert not torch.equal(out, plain)  # the int8 products ran
    port.train()  # BERT is frozen and deterministic: train mode keeps int8
    with torch.no_grad():
        assert torch.equal(port(_t(ids), _t(mask)), out)


@pytest.mark.parametrize("dense_impl", ["int8", "int8_static"])
def test_training_ignores_dense_impl(tree, dense_impl):
    """Train mode runs the float dense: logits and gradients bit-equal to
    dense_impl 'xla'; eval mode differs."""
    _, ref = _models(tree)
    _, port = _models(tree, dense_impl=dense_impl)
    batch = {k: _t(v) for k, v in _batch("snli-ve").items()}
    outs = []
    for model in (ref, port):
        model.train()
        logits = model("snli-ve", batch)
        logits.square().sum().backward()
        outs.append((logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                       if p.grad is not None}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys()
    assert all(torch.equal(outs[0][1][n], outs[1][1][n]) for n in outs[0][1])
    with torch.no_grad():
        assert not torch.equal(ref.eval()("snli-ve", batch), port.eval()("snli-ve", batch))


def test_int8_static_without_scales_is_dynamic(tree):
    """No calibration (the evals inside a training run): int8_static serves
    dynamic int8, as JAX falls back."""
    _, dynamic = _models(tree, dense_impl="int8")
    _, static = _models(tree, dense_impl="int8_static")
    batch = {k: _t(v) for k, v in _batch("vcr").items()}
    with torch.no_grad():
        assert torch.equal(static("vcr", batch), dynamic("vcr", batch))
    scales = eval_step.calibrate_quant_scales(static, "vcr", [batch])
    assert scales and all(float(v) > 0 for v in scales.values())
    assert not any(k.endswith("_amax") for k in static.state_dict())  # checkpoints unchanged
    with torch.no_grad():
        assert not torch.equal(static("vcr", batch), dynamic("vcr", batch))
    quant.clear_quant_buffers(static)
    with torch.no_grad():
        assert torch.equal(static("vcr", batch), dynamic("vcr", batch))


def test_phase1_driver_evaluates_int8_static(tmp_path):
    """A training driver with --dense_impl int8_static trains in float and
    evaluates with dynamic int8 (no calibration there)."""
    from climb_tpu_torch.cli.train_upstream_continual_learning import main

    main(["--device", "cpu", "--encoder_name", "vilt", "--pretrained_model_name", "scratch",
          "--climb_data_dir", str(tmp_path), "--synthetic", "--tiny",
          "--synthetic_train_size", "16", "--batch_size", "8", "--output_dir", str(tmp_path),
          "--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft",
          "--dense_impl", "int8_static", "--do_train", "--do_eval"])
    assert list(tmp_path.glob("*/results.json"))


def test_tiny_config_is_the_jax_one():
    assert dataclasses.asdict(ViltConfig(**TINY))["dense_impl"] == "xla"
    assert JaxViltConfig(**TINY).dense_impl == "xla"
