"""Pretrained weights from local Hugging Face snapshots: the port's
``models.hf_snapshot`` through ``train.model_factory`` against the JAX
package's ``_graft_pretrained`` and ``load_encoder_params``, which go through
``from_pretrained``.

The cases of ``tests/test_pretrained_path.py`` (a random-init
``transformers.ViltModel`` saved with ``save_pretrained``: the learner's
graft, the NLVR2 modality-row expansion, the Phase II encoder, 'nlvr2' in the
checkpoint's name, the fallback to the seed's weights) run on that directory
and on the hub-cache form (``dandelin/vilt-b32-mlm`` in a cache of the
``ViltForMaskedLM`` layout: ``vilt.`` keys and ``mlm_score.*``), which JAX
resolves under ``HF_HUB_OFFLINE=1``; then ViLT-BERT's BERT from a
``bert-base-uncased`` entry in ``pytorch_model.bin`` with ``bert.`` keys,
``gamma``/``beta`` names and ``cls.*``; then the hand-written safetensors
reader against the ``safetensors`` package. Encoder tensors are held
bit-equal.
"""

import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import transformers

from climb_tpu.configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.model_factory import load_encoder_params as jax_load_encoder_params
from climb_tpu.train.model_factory import vilt_config_from_args as jax_vilt_config
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.models import hf_snapshot
from climb_tpu_torch.train.model_factory import (
    create_cl_model,
    load_encoder_params,
    vilt_config_from_args,
)
from test_torch_data_common import shape_only_flax_init
from test_torch_hf_common import (
    BERT_TINY,
    VILT_TINY,
    offline_hub,
    snapshot_dir,
    write_bert_snapshot,
    write_vilt_snapshot,
)

HUB_NAME = "dandelin/vilt-b32-mlm"


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A save_pretrained directory and a hub cache holding the same ViLT
    weights, and a bert-base-uncased entry in that cache."""
    torch.manual_seed(0)
    vilt = transformers.ViltModel(transformers.ViltConfig(**VILT_TINY))
    with torch.no_grad():  # give the zero-init embeddings signal
        vilt.embeddings.position_embeddings.normal_(0, 0.02)
        vilt.embeddings.cls_token.normal_(0, 0.02)
    bert = transformers.BertModel(transformers.BertConfig(**BERT_TINY))
    root = tmp_path_factory.mktemp("hf")
    vilt.save_pretrained(str(root / "vilt_dir"))
    hub = root / "hub"
    write_vilt_snapshot(hub, vilt)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat"]
    write_bert_snapshot(hub, bert, words)
    return SimpleNamespace(dir=str(root / "vilt_dir"), hub=hub, vilt=vilt.state_dict(),
                           bert=bert.state_dict())


@pytest.fixture
def hub(snapshots, monkeypatch):
    """The hub cache for both packages, offline. JAX's initialization gives
    shapes only: every encoder leaf is then the snapshot's (a leaf left
    unloaded would fail the conversion), and the heads are not compared."""
    offline_hub(monkeypatch, snapshots.hub)
    shape_only_flax_init(monkeypatch)
    return snapshots


def _args(path, tasks, encoder="vilt"):
    return SimpleNamespace(batch_size=4, seed=0, ordered_cl_tasks=tasks, encoder_name=encoder,
                           pretrained_model_name=path, tiny=True, synthetic=True)


def _assert_equal(got, want, prefix=""):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _encoder(jax_params, key):
    """A JAX learner's encoder subtree under the port's learner names."""
    return {f"{key}.{k}": v for k, v in state_dict_from_jax(jax_params[key]).items()}


def _name(form, snapshots):
    return snapshots.dir if form == "dir" else HUB_NAME


@pytest.mark.parametrize("form", ["dir", "hub"])
@pytest.mark.parametrize("tasks", [["snli-ve"], ["nlvr2", "snli-ve"]])
def test_create_cl_model_grafts_pretrained(form, tasks, hub):
    """The learner's encoder after the graft, bit for bit JAX's; with NLVR2 in
    the sequence the third modality row is the image row (reference
    vilt.py:98-109). The heads keep each package's own initialization."""
    name = _name(form, hub)
    ref = jax_create_cl_model(_args(name, tasks), jax_task_configs)
    model = create_cl_model(_args(name, tasks), task_configs, torch.device("cpu"))
    got = model.state_dict()
    _assert_equal(got, _encoder(ref.params, "vilt"))
    assert torch.equal(got["vilt.word_embeddings.weight"],
                       hub.vilt["embeddings.text_embeddings.word_embeddings.weight"])
    mod = got["vilt.modality_type_embeddings.weight"]
    assert mod.shape[0] == (3 if "nlvr2" in tasks else 2)
    assert torch.equal(mod[-1], hub.vilt["embeddings.token_type_embeddings.weight"][1])


@pytest.mark.parametrize("form", ["dir", "hub"])
@pytest.mark.parametrize("checkpoint", [None, "/nonexistent/task1_nlvr2/encoder"])
def test_load_encoder_params_pretrained(form, checkpoint, hub):
    """The Phase II encoder (reference load_vilt_encoder, vilt.py:481-514)
    from the snapshot; 'nlvr2' in the checkpoint's name expands the modality
    rows even though the file is not there."""
    name = _name(form, hub)
    jcfg = jax_vilt_config(SimpleNamespace(tiny=True), needs_three_modalities=False)
    ref, ref_cfg = jax_load_encoder_params(checkpoint, jcfg, pretrained=name)
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=False)
    got, out_cfg = load_encoder_params(checkpoint, cfg, pretrained=name)
    assert out_cfg.modality_type_vocab_size == ref_cfg.modality_type_vocab_size == (
        3 if checkpoint else 2)
    _assert_equal(got, state_dict_from_jax(ref))
    assert got.keys() == state_dict_from_jax(ref).keys()


def test_missing_pretrained_falls_back_to_the_seed(hub, caplog):
    """A name that resolves to nothing: the seed's weights and a warning (JAX
    warns and keeps its own initialization); nothing raises."""
    with caplog.at_level(logging.WARNING):
        model = create_cl_model(_args("/nonexistent/vilt-b32", ["snli-ve"]), task_configs,
                                torch.device("cpu"))
    assert "no local snapshot or file" in caplog.text
    scratch = create_cl_model(_args("scratch", ["snli-ve"]), task_configs, torch.device("cpu"))
    _assert_equal(model.state_dict(), scratch.state_dict())
    assert not torch.equal(model.state_dict()["vilt.word_embeddings.weight"],
                           hub.vilt["embeddings.text_embeddings.word_embeddings.weight"])
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=False)
    got, _ = load_encoder_params(None, cfg, pretrained="org/not-cached")
    base, _ = load_encoder_params(None, cfg, pretrained="scratch")
    _assert_equal(got, base)


def test_viltbert_grafts_vilt_and_bert(hub, monkeypatch):
    """ViLT-BERT: the ViLT side from the hub's ViLT entry, BERT from its
    bert-base-uncased entry (JAX model_factory.py:270-281), the learner and
    the Phase II encoder, bit for bit JAX's."""
    monkeypatch.setenv("USE_TF", "0")
    ref = jax_create_cl_model(_args(HUB_NAME, ["snli-ve"], "viltbert"), jax_task_configs)
    model = create_cl_model(_args(HUB_NAME, ["snli-ve"], "viltbert"), task_configs,
                            torch.device("cpu"))
    got = model.state_dict()
    _assert_equal(got, _encoder(ref.params, "viltbert"))
    assert torch.equal(got["viltbert.bert.embed_layernorm.weight"],
                       hub.bert["embeddings.LayerNorm.weight"])
    assert torch.equal(got["viltbert.vilt.pooler.weight"], hub.vilt["pooler.dense.weight"])
    jcfg = jax_vilt_config(SimpleNamespace(tiny=True), needs_three_modalities=False)
    ref_enc, _ = jax_load_encoder_params(None, jcfg, pretrained=HUB_NAME,
                                         encoder_name="viltbert")
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=False)
    enc, _ = load_encoder_params(None, cfg, pretrained=HUB_NAME, encoder_name="viltbert")
    _assert_equal(enc, state_dict_from_jax(ref_enc))


def test_viltbert_without_a_bert_snapshot_warns(snapshots, tmp_path, monkeypatch, caplog):
    """No bert-base-uncased in the cache: the ViLT side loads, BERT keeps the
    seed's weights, with the warning."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with caplog.at_level(logging.WARNING):
        model = create_cl_model(_args(snapshots.dir, ["snli-ve"], "viltbert"), task_configs,
                                torch.device("cpu"))
    assert "holds no BERT weights" in caplog.text
    scratch = create_cl_model(_args("scratch", ["snli-ve"], "viltbert"), task_configs,
                              torch.device("cpu"))
    _assert_equal(model.state_dict(), scratch.state_dict(), "viltbert.bert.")
    assert torch.equal(model.state_dict()["viltbert.vilt.cls_token"],
                       snapshots.vilt["embeddings.cls_token"])


def test_resolve_snapshot_follows_the_cache_rules(tmp_path, monkeypatch):
    """$HF_HUB_CACHE, else $HF_HOME/hub, else ~/.cache/huggingface/hub; refs/main
    names the revision; a directory is used as it is; a snapshot without a
    weights file (a cache holding the tokenizer only) gives no weights."""
    for var in ("HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    default = tmp_path / "home" / ".cache" / "huggingface" / "hub"
    snap = snapshot_dir(default, "org/name")
    assert hf_snapshot.resolve_snapshot("org/name") == snap
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    assert hf_snapshot.resolve_snapshot("org/name") is None
    assert hf_snapshot.resolve_snapshot("solo") is None
    snap2 = snapshot_dir(tmp_path / "hf_home" / "hub", "solo")
    assert hf_snapshot.resolve_snapshot("solo") == snap2
    monkeypatch.setenv("HF_HUB_CACHE", str(default))
    assert hf_snapshot.resolve_snapshot("org/name") == snap
    assert hf_snapshot.resolve_snapshot(str(tmp_path)) == str(tmp_path)
    for bad in ("", "a/b/c", "/abs/x", "org/", "scratch"):
        assert hf_snapshot.resolve_snapshot(bad) is None, bad
    os.remove(os.path.join(str(default), "models--org--name", "refs", "main"))
    assert hf_snapshot.resolve_snapshot("org/name") is None
    assert hf_snapshot.pretrained_vilt(snap2) is None  # no weights file there


def test_safetensors_reader_matches_the_package(tmp_path):
    """The hand-written reader against ``safetensors.torch.load_file``: every
    dtype the reader takes, a scalar, an empty tensor, metadata; a sharded
    index; and a header that overruns the file."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(3)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "f64": torch.randn(4, generator=g).double(),
        "i64": torch.randint(-9, 9, (5,), generator=g), "i32": torch.arange(6).int(),
        "i16": torch.arange(3).short(), "i8": torch.arange(-3, 3).to(torch.int8),
        "u8": torch.arange(250, 256).to(torch.uint8),
        "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    from safetensors.torch import load_file

    ref, got = load_file(path), hf_snapshot.read_safetensors(path)
    assert got.keys() == ref.keys() == tensors.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k

    shards = tmp_path / "sharded"
    shards.mkdir()
    names = sorted(tensors)
    parts = {"model-00001-of-00002.safetensors": names[:5],
             "model-00002-of-00002.safetensors": names[5:]}
    for shard, keys in parts.items():
        save_file({k: tensors[k] for k in keys}, str(shards / shard))
    (shards / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: s for s, keys in parts.items() for k in keys}}))
    sharded = hf_snapshot.read_weights(str(shards))
    assert sharded.keys() == ref.keys() and all(torch.equal(sharded[k], ref[k]) for k in ref)

    data = bytearray(open(path, "rb").read())
    data[:8] = (len(data)).to_bytes(8, "little")
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="overruns"):
        hf_snapshot.read_safetensors(str(bad))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        hf_snapshot.read_weights(str(tmp_path / "empty"))


def test_base_model_weights_normalizes_task_checkpoints():
    """transformers' rules for a base model read from a task checkpoint:
    gamma/beta renamed, the prefix stripped, the heads and other keys dropped;
    a base checkpoint passes whole; floats become float32."""
    t = torch.ones(2, dtype=torch.float16)
    task = {"bert.embeddings.LayerNorm.gamma": t, "bert.embeddings.LayerNorm.beta": t,
            "bert.encoder.layer.0.output.dense.weight": t, "cls.predictions.bias": t,
            "other.weight": t, "bert.ids": torch.arange(2)}
    got = hf_snapshot.base_model_weights(task, "bert", ("cls.",))
    assert sorted(got) == ["embeddings.LayerNorm.bias", "embeddings.LayerNorm.weight",
                           "encoder.layer.0.output.dense.weight", "ids"]
    assert got["embeddings.LayerNorm.weight"].dtype == torch.float32
    assert got["ids"].dtype == torch.int64
    base = {"embeddings.LayerNorm.weight": t, "pooler.dense.bias": t}
    assert sorted(hf_snapshot.base_model_weights(base, "bert", ("cls.",))) == sorted(base)
    np.testing.assert_array_equal(
        hf_snapshot.base_model_weights(base, "bert", ())["pooler.dense.bias"].numpy(), 1.0)
