"""climb_tpu_torch's ViLT-BERT against climb_tpu's on the CPU: the modules.

One JAX parameter tree with every leaf drawn from numpy feeds both packages
(through ``state_dict_from_jax``), on the tiny config (hidden 64, 2 layers, 4
heads, FFN 128), float32:

- ``BertCore`` against JAX's ``BertCore`` on every position, and against a
  randomly initialised ``transformers.BertModel`` through ``hf_import`` on the
  unmasked positions (HF computes the masked ones with another bias);
- ``ViltBertContinualLearner`` logits and ViLT-side gradients on the
  single-image (snli-ve), image-pair (nlvr2) and multiple-choice (vcr) paths,
  and ``ViltBertClassifier``'s on the classification and multiple-choice
  paths with the shared mean image; BERT gets no gradient in either package;
- the trainability masks (the frozen-BERT mask, the freeze and adapter
  masks, weight decay) against JAX's;
- the weight bridge: both reference layouts (``viltbert_encoder.*`` model
  files and ``vilt.*`` + ``bert.*`` encoder files) against JAX's export and
  import, and back; ``load_encoder_params`` on the ViLT-BERT layouts.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ckpt.torch_import import convert_torch_state_dict, export_torch_state_dict
from climb_tpu.cl import freeze as jax_freeze
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.models.bert import BertConfig as JaxBertConfig
from climb_tpu.models.bert import BertCore as JaxBertCore
from climb_tpu.models.viltbert import ViltBertClassifier as JaxClassifier
from climb_tpu.models.viltbert import ViltBertContinualLearner as JaxLearner
from climb_tpu.models.viltbert import viltbert_frozen_mask as jax_frozen_mask
from climb_tpu.train.model_factory import vilt_config_from_args as jax_cfg_from_args
from climb_tpu.train.optimizer import weight_decay_mask as jax_wd_mask
from climb_tpu.train.train_step import compute_loss as jax_compute_loss
from climb_tpu.train.train_step import prepare_batch as jax_prepare_batch
from climb_tpu_torch.ckpt.checkpoint import save_state_dict
from climb_tpu_torch.ckpt.convert import (
    reference_from_state_dict,
    state_dict_from_jax,
    state_dict_from_reference,
)
from climb_tpu_torch.cl import freeze
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.models import hf_import
from climb_tpu_torch.models.bert import BertCore, bert_config_for
from climb_tpu_torch.models.model_config import head_specs_from_task_configs
from climb_tpu_torch.models.viltbert import (
    ViltBertClassifier,
    ViltBertContinualLearner,
    viltbert_frozen_mask,
)
from climb_tpu_torch.train.eval_step import prepare_batch
from climb_tpu_torch.train.model_factory import load_encoder_params, vilt_config_from_args
from climb_tpu_torch.train.optimizer import weight_decay_mask
from climb_tpu_torch.train.train_step import compute_loss

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4                 # hidden states and logits (tests/test_viltbert.py)
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3       # f32 sums in another order, forward and backward
TASKS = ("snli-ve", "nlvr2", "vcr")
LOSSES = {"snli-ve": "ce", "nlvr2": "ce", "vcr": "mc_ce"}
TINY = SimpleNamespace(tiny=True)
VOCAB = 2048  # the tiny config's


def _randomize(tree, seed):
    """Every leaf from numpy (LayerNorm scales near 1): no zero-initialized
    leaf hides a wrong mapping."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.randn(*np.shape(x)) * 0.1
                      + (getattr(p[-1], "key", "") == "scale")).astype(np.float32), tree)


def _text(rng, shape):
    ids = rng.randint(1, VOCAB, shape).astype(np.int32)
    lens = rng.randint(3, 40, shape[:-1])
    mask = (np.arange(40) < lens[..., None]).astype(np.float32)
    return ids * mask.astype(np.int32), mask, rng.randint(0, 2, shape).astype(np.int32)


def _batch(task, seed=0):
    rng = np.random.RandomState(seed)
    lead = {"nlvr2": (2,), "vcr": (2, 4)}.get(task, (3,))
    ids, mask, tt = _text(rng, lead + (40,))
    b = lead[0]
    if task == "nlvr2":
        pv = rng.randint(0, 256, (b, 2, 64, 96, 3)).astype(np.uint8)
        phw = np.array([[[2, 3], [1, 2]], [[2, 1], [2, 3]]], np.int32)
    else:
        pv = rng.randint(0, 256, (b, 64, 96, 3)).astype(np.uint8)
        phw = np.array([[2, 3], [1, 2], [2, 1]], np.int32)[:b]
    labels = rng.randint(0, 4 if task == "vcr" else 2, (b,)).astype(np.int32)
    return {"input_ids": ids, "text_mask": mask, "token_type_ids": tt, "pixel_values": pv,
            "patch_hw": phw, "labels": labels}


@pytest.fixture(scope="module")
def learners():
    """The JAX learner, its numpy tree and the port's learner holding it."""
    cfg = jax_cfg_from_args(TINY, needs_three_modalities=True)
    jmodule = JaxLearner(cfg=cfg, head_specs=jax_head_specs(TASKS, jax_task_configs))
    dummy = {"input_ids": jnp.zeros((2, 40), jnp.int32), "text_mask": jnp.ones((2, 40)),
             "pixel_values": jnp.zeros((2, 64, 96, 3)), "patch_hw": jnp.ones((2, 2), jnp.int32)}
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), dummy,
                                                 method=JaxLearner.init_all))["params"]
    tree = _randomize(shapes, 1)
    port = ViltBertContinualLearner(vilt_config_from_args(TINY, True),
                                    head_specs_from_task_configs(TASKS, task_configs))
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    return jmodule, tree, port


# ---- BERT -----------------------------------------------------------------------


def test_bert_core_matches_jax(learners):
    _, tree, port = learners
    ids, mask, tt = _text(np.random.RandomState(4), (3, 40))
    c = bert_config_for(port.cfg)  # JAX ViltBertCore's BERT (viltbert.py:39-49)
    jcore = JaxBertCore(JaxBertConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                                      num_layers=c.num_layers, num_heads=c.num_heads,
                                      intermediate_size=c.intermediate_size))
    ref = jax.jit(jcore.apply)({"params": tree["viltbert"]["bert"]}, ids, mask, tt)
    core = BertCore(bert_config_for(port.cfg))
    core.load_state_dict(state_dict_from_jax(tree["viltbert"]["bert"]), strict=True)
    with torch.inference_mode():
        out = core(*(torch.from_numpy(a) for a in (ids, mask, tt)))
    assert out.shape == (3, 40, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_bert_core_matches_hf_bert_model(monkeypatch):
    """A random ``transformers.BertModel``'s weights through ``hf_import``."""
    monkeypatch.setenv("USE_TF", "0")  # transformers need not import TensorFlow here
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.BertConfig(
        vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    hf = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    sd = hf.state_dict()
    core = BertCore(dataclasses.replace(bert_config_for(vilt_config_from_args(TINY, False)),
                                        vocab_size=100))
    core.load_state_dict(hf_import.bert_from_hf(sd), strict=True)
    back = hf_import.bert_to_hf(core.state_dict())
    assert all(torch.equal(back[k], sd[k]) for k in back)
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(1, 100, (2, 12)))
    mask = torch.ones(2, 12)
    mask[1, 9:] = 0.0
    tt = torch.from_numpy(rng.randint(0, 2, (2, 12)))
    with torch.inference_mode():
        ref = hf(input_ids=ids, attention_mask=mask, token_type_ids=tt).last_hidden_state
        out = core(ids, mask, tt)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out[1, :9].numpy(), ref[1, :9].numpy(), atol=ATOL, rtol=RTOL)


def test_bert_rejects_text_beyond_its_positions():
    core = BertCore(dataclasses.replace(bert_config_for(vilt_config_from_args(TINY, False)),
                                        max_position_embeddings=8))
    with pytest.raises(ValueError, match="8 position slots"):
        core(torch.zeros(1, 9, dtype=torch.int64), torch.ones(1, 9))


# ---- the learner and the classifier -----------------------------------------------


def _jax_grads(apply, tree, jbatch, loss_type):
    def loss_fn(params):
        logits = apply(params, jbatch)
        return jax_compute_loss(logits, jbatch, loss_type), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    return np.asarray(logits), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _assert_grads(model, logits, ref_logits, ref_grads):
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=ATOL, rtol=RTOL)
    reached = 0
    for n, p in model.named_parameters():
        if ".bert." in n or p.grad is None:  # BERT and unreached leaves: 0 in JAX
            assert p.grad is None and not ref_grads[n].abs().max(), n
            continue
        reached += 1
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[n].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)
    assert reached > 20


@pytest.mark.parametrize("task", TASKS)
def test_learner_logits_and_gradients_match_jax(learners, task):
    jmodule, tree, port = learners
    batch = _batch(task)
    jbatch = jax_prepare_batch({k: jnp.asarray(v) for k, v in batch.items()})
    ref_logits, ref_grads = _jax_grads(
        lambda p, b: jmodule.apply({"params": p}, task, b), tree, jbatch, LOSSES[task])
    port.zero_grad(set_to_none=True)
    pbatch = prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    logits = port.eval()(task, pbatch)
    compute_loss(logits, pbatch, LOSSES[task]).backward()
    _assert_grads(port, logits, ref_logits, ref_grads)
    assert port.encoder_key == "viltbert" and port.viltbert.vilt.word_embeddings.weight.grad \
        is None  # the BERT output stands in for ViLT's word embeddings


@pytest.mark.parametrize("model_type", ["classification", "multi-choice"])
def test_classifier_logits_and_gradients_match_jax(model_type):
    """Sequence classification and multiple choice over one shared mean image
    (a ``pixel_values`` of batch 1)."""
    cfg = jax_cfg_from_args(TINY, needs_three_modalities=False)
    num_labels = 3
    task = "vcr" if model_type == "multi-choice" else "snli-ve"
    batch = _batch(task, seed=6)
    if model_type == "multi-choice":
        batch = {k: v[:, :num_labels] if k in ("input_ids", "text_mask", "token_type_ids")
                 else v for k, v in batch.items()}
    batch["pixel_values"], batch["patch_hw"] = batch["pixel_values"][:1], batch["patch_hw"][:1]
    batch["labels"] = batch["labels"] % num_labels
    jmodule = JaxClassifier(cfg=cfg, num_labels=num_labels, model_type=model_type)
    jbatch = jax_prepare_batch({k: jnp.asarray(v) for k, v in batch.items()})
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jbatch))["params"]
    tree = _randomize(shapes, 7)
    loss_type = "mc_ce" if model_type == "multi-choice" else "ce"
    ref_logits, ref_grads = _jax_grads(lambda p, b: jmodule.apply({"params": p}, b), tree,
                                       jbatch, loss_type)
    port = ViltBertClassifier(vilt_config_from_args(TINY, False), num_labels, model_type)
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    pbatch = prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    logits = port.eval()(pbatch)
    compute_loss(logits, pbatch, loss_type).backward()
    _assert_grads(port, logits, ref_logits, ref_grads)


# ---- masks ------------------------------------------------------------------------


def _mask_by_name(tree, jax_mask):
    """A JAX mask tree on the port's names: each leaf broadcast to its
    parameter's shape (a stacked leaf's layer i becomes block i's tensors),
    one value per port tensor."""
    full = jax.tree_util.tree_map(
        lambda m, p: np.broadcast_to(np.asarray(m, np.float32), np.shape(p)).copy(),
        jax_mask, tree)
    out = {}
    for n, t in state_dict_from_jax(full).items():
        values = torch.unique(t)
        assert values.numel() == 1, n
        out[n] = float(values)
    return out


def _floats(mask):
    return {n: float(m) for n, m in mask.items()}


def test_frozen_bert_mask_matches_jax(learners):
    _, tree, port = learners
    got = _floats(viltbert_frozen_mask(port))
    assert got == _mask_by_name(tree, jax_frozen_mask(tree))
    assert {n for n, m in got.items() if not m} == \
        {n for n in got if n.startswith("viltbert.bert.")}


def test_freeze_masks_match_jax_on_the_vilt_side(learners):
    """The freeze algorithms' masks: JAX's on ViLT's side and the heads. BERT
    stays frozen in the port, where JAX's driver (default key 'vilt') leaves
    it at 1, so that weight decay moves it there."""
    _, tree, port = learners
    cases = [(freeze.freeze_encoder_mask(port, "viltbert"), jax_freeze.freeze_encoder_mask(tree)),
             (freeze.freeze_bottom_k_layers_mask(port, 1, 2, "viltbert"),
              jax_freeze.freeze_bottom_k_layers_mask(tree, 1, 2))]
    for got, jax_mask in cases:
        ref = _mask_by_name(tree, jax_mask)
        for n, m in _floats(got).items():
            if n.startswith("viltbert.bert."):
                assert m == 0.0 and ref[n] == 1.0, n
            else:
                assert m == ref[n], n
    got = _floats(freeze.adapter_only_mask(port, "nlvr2"))
    assert {n for n, m in got.items() if m} == {n for n in got if n.startswith("head_nlvr2.")}


def test_weight_decay_mask_matches_jax(learners):
    _, tree, port = learners
    ref = _mask_by_name(tree, jax_wd_mask(tree))
    got = weight_decay_mask([n for n, _ in port.named_parameters()])
    assert got == {n: bool(m) for n, m in ref.items()}
    assert not got["viltbert.bert.encoder.0.attn_ln.weight"]
    assert got["viltbert.bert.encoder.0.fc1.weight"]


# ---- the weight bridge ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["model", "encoder"])
def test_reference_layouts_round_trip_against_jax(learners, kind):
    """The port's export equals JAX's ``export_torch_state_dict`` tensor for
    tensor; JAX imports it to the tree; the port imports it back."""
    _, tree, port = learners
    sd = port.state_dict()
    out = reference_from_state_dict(sd, kind, "viltbert")
    ref = export_torch_state_dict(tree, kind)
    assert out.keys() == ref.keys()
    assert all(np.array_equal(out[k].numpy(), ref[k]) for k in ref)
    prefix = "viltbert_encoder." if kind == "model" else ""
    assert any(k.startswith(prefix + "bert.") for k in out)
    assert any(k.startswith(prefix + "vilt.") for k in out)
    back = convert_torch_state_dict(out)
    assert set(back["viltbert"]) == {"vilt", "bert"}
    again = state_dict_from_reference(out)
    enc = {k: v for k, v in sd.items() if kind == "model" or k.startswith("viltbert.")}
    assert again.keys() == enc.keys()
    assert all(torch.equal(again[k], enc[k]) for k in enc)


def test_load_encoder_params_on_viltbert_layouts(learners, tmp_path):
    """A ViLT-BERT encoder or model file loads both sides; a ViLT file grafts
    ViLT's side and BERT keeps the seed's weights (JAX
    ``model_factory.py:225-240``); the result is a ``ViltBertCore`` state dict."""
    _, _, port = learners
    sd = port.state_dict()
    core = {k[len("viltbert."):]: v for k, v in sd.items() if k.startswith("viltbert.")}
    pcfg = vilt_config_from_args(TINY, False)
    scratch, cfg = load_encoder_params(None, pcfg, "scratch", seed=3, encoder_name="viltbert")
    assert scratch.keys() == core.keys() and cfg.modality_type_vocab_size == 2
    d = tmp_path / "task1_nlvr2"  # three modality rows, as the learner has
    d.mkdir()
    torch.save(reference_from_state_dict(sd, "encoder", "viltbert"), d / "encoder")
    torch.save(reference_from_state_dict(sd, "model", "viltbert"), d / "model")
    save_state_dict(core, str(d / "port_core"))
    vilt_sd = {"vilt." + k[len("viltbert.vilt."):]: v for k, v in sd.items()
               if k.startswith("viltbert.vilt.")}
    torch.save(reference_from_state_dict(vilt_sd, "encoder"), d / "vilt_encoder")
    for name in ("encoder", "model", "port_core"):
        got, cfg3 = load_encoder_params(str(d / name), pcfg, "scratch", seed=3,
                                        encoder_name="viltbert")
        assert cfg3.modality_type_vocab_size == 3
        assert all(torch.equal(got[k], core[k]) for k in core), name
    got, _ = load_encoder_params(str(d / "vilt_encoder"), pcfg, "scratch", seed=3,
                                 encoder_name="viltbert")
    scratch3, _ = load_encoder_params(str(tmp_path / "task1_nlvr2" / "none"), pcfg, "scratch",
                                      seed=3, encoder_name="viltbert")
    for k in core:
        assert torch.equal(got[k], core[k] if k.startswith("vilt.") else scratch3[k]), k
    # a ViLT encoder takes the ViLT side of a ViLT-BERT file
    got, _ = load_encoder_params(str(d / "encoder"), pcfg, "scratch", seed=3)
    assert all(torch.equal(got[k], core["vilt." + k]) for k in got)
