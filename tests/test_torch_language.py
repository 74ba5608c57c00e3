"""climb_tpu_torch's Phase II language path against climb_tpu's on the CPU.

Model surgery, ``ViltClassifier``, the synthetic text data, the mean-image
canvas and the configs against their JAX counterparts on the same numpy
inputs; the port's attention plain versions against the JAX long-sequence
path (``_fwd_kernel_blocked`` in interpret mode and ``_bwd_blockwise_xla``,
forced at a small size as ``tests/test_pallas_kernels.py`` forces them); and
``cli.train_language`` against the JAX driver's results JSON, the port
starting from the JAX driver's initial parameters of the same seed.
"""

import ast
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climb_tpu.models.vilt as jax_vilt
import climb_tpu.ops.pallas_attention as pa
import climb_tpu.train.downstream as jax_downstream
from climb_tpu.cli.train_language import main as jax_main
from climb_tpu.configs import model_configs as jax_model_configs
from climb_tpu.configs import task_configs as jax_task_configs
from climb_tpu.data.image_pipeline import process_image as jax_process_image
from climb_tpu.data.mean_image import load_mean_image as jax_load_mean_image
from climb_tpu.data.synthetic import SyntheticTextDataset as JaxTextDataset
from climb_tpu.models import ViltClassifier as JaxClassifier
from climb_tpu.models import ViltCore as JaxCore
from climb_tpu.models import surgery as jax_surgery
from climb_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args
from climb_tpu_torch.ckpt.checkpoint import save_state_dict
from climb_tpu_torch.ckpt.convert import reference_from_state_dict, state_dict_from_jax
from climb_tpu_torch.cli import train_language as port
from climb_tpu_torch.configs.model_configs import model_configs
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.image_pipeline import process_image, vilt_resize_dims
from climb_tpu_torch.data.mean_image import load_mean_image
from climb_tpu_torch.data.synthetic import SyntheticTextDataset
from climb_tpu_torch.models import heads, surgery
from climb_tpu_torch.models.vilt import ViltClassifier
from climb_tpu_torch.ops import attention
from climb_tpu_torch.train.model_factory import load_encoder_params
from climb_tpu_torch.train.model_factory import vilt_config_from_args as port_cfg_from_args
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LANGUAGE_TASKS = ["imdb", "sst2", "hellaswag", "commonsenseqa", "piqa"]
ATOL, RTOL = 2e-5, 1e-4  # f32 sums in another order (tests/test_pallas_kernels.py)
TINY = SimpleNamespace(tiny=True)


def _numpy_tree(shapes, seed):
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 1.0 if getattr(p[-1], "key", "") == "scale" else x, tree)


@pytest.fixture(scope="module")
def core_tree():
    cfg = vilt_config_from_args(TINY, needs_three_modalities=False)
    b = dummy_batch(cfg)
    shapes = jax.eval_shape(lambda: JaxCore(cfg).init(
        jax.random.PRNGKey(0), b["input_ids"], b["text_mask"], b["pixel_values"], b["patch_hw"]))
    return cfg, _numpy_tree(shapes["params"], 3)


# ---- configs, data ---------------------------------------------------------------


@pytest.mark.parametrize("task", LANGUAGE_TASKS)
def test_language_task_configs_equal_jax(task):
    assert task_configs[task] == jax_task_configs[task]


@pytest.mark.parametrize("key", ["vilt", "vilt-l-seq", "vilt-l-mc", "vilt-v-cls", "viltbert",
                                 "viltbert-l-seq", "viltbert-l-mc"])
def test_model_configs_equal_jax(key):
    assert model_configs[key] == jax_model_configs[key]


@pytest.mark.parametrize("model_type,num_choices", [("classification", None),
                                                    ("multi-choice", 3)])
def test_synthetic_text_dataset_equals_jax(model_type, num_choices):
    kw = dict(size=9, num_labels=3, model_type=model_type, num_choices=num_choices, max_len=24,
              seed=7)
    ref, got = JaxTextDataset(**kw), SyntheticTextDataset(**kw)
    assert len(got) == len(ref) == 9
    np.testing.assert_array_equal(got.labels, ref.labels)
    for i in range(9):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


@pytest.mark.parametrize("image_size,canvas", [(None, (384, 640)), ((128, 128), (128, 128))])
def test_mean_image_canvas_equals_jax(image_size, canvas):
    ref_canvas, ref_hw = jax_process_image(jax_load_mean_image(None, image_size), canvas)
    got_canvas, got_hw = process_image(load_mean_image(None, image_size), canvas)
    assert got_hw == ref_hw and got_canvas.dtype == np.uint8
    np.testing.assert_array_equal(got_canvas, ref_canvas)
    assert vilt_resize_dims(480, 640) == (384, 512)
    # a resized photo-like array goes through PIL's bicubic filter in both
    img = np.random.RandomState(0).randint(0, 256, (60, 90, 3)).astype(np.uint8)
    a, b = process_image(img, (128, 128)), jax_process_image(img, (128, 128))
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0], b[0])


# ---- surgery, classifier ----------------------------------------------------------


def test_reallocate_text_image_matches_jax(core_tree):
    cfg, tree = core_tree
    pcfg = port_cfg_from_args(TINY, False)
    ref_tree, ref_cfg = jax_surgery.reallocate_text_image(tree, cfg, 90, (128, 128))
    got, got_cfg = surgery.reallocate_text_image(state_dict_from_jax(tree), pcfg, 90, (128, 128))
    assert (got_cfg.max_text_len, got_cfg.image_height, got_cfg.image_width) == \
        (ref_cfg.max_text_len, ref_cfg.image_height, ref_cfg.image_width) == (120, 128, 128)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert got["text_position_embeddings"].shape[0] == 120
    # under a prefix too (a classifier's or a learner's state dict)
    prefixed, _ = surgery.reallocate_text_image(
        {"vilt." + k: v for k, v in state_dict_from_jax(tree).items()}, pcfg, 90)
    assert torch.equal(prefixed["vilt.text_position_embeddings"], ref["text_position_embeddings"])


def test_expand_modality_type_embeddings_matches_jax(core_tree):
    cfg, tree = core_tree
    pcfg = port_cfg_from_args(TINY, False)
    ref_tree, ref_cfg = jax_surgery.expand_modality_type_embeddings(tree, cfg)
    got, got_cfg = surgery.expand_modality_type_embeddings(state_dict_from_jax(tree), pcfg)
    assert got_cfg.modality_type_vocab_size == ref_cfg.modality_type_vocab_size == 3
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    again, _ = surgery.expand_modality_type_embeddings(got, got_cfg)
    assert again is got  # three rows already: unchanged


@pytest.mark.parametrize("model_type", ["classification", "multi-choice"])
def test_classifier_matches_jax(model_type):
    """Sequence and multi-choice forward with the shared mean image (a
    pixel_values of batch 1) and token_type_ids, after reallocate_text_image."""
    cfg = vilt_config_from_args(TINY, False).replace(max_text_len=80, image_height=128,
                                                     image_width=128)
    num_labels, max_len = 3, 80
    ds = JaxTextDataset(4, num_labels, model_type, num_labels if model_type != "classification"
                        else None, max_len, seed=1)
    batch = {k: np.stack([ds[i][k] for i in range(4)]) for k in ds[0]}
    batch["token_type_ids"] = (batch["input_ids"] % 2).astype(np.int32)
    canvas, hw = process_image(load_mean_image(None, (128, 128)), (128, 128))
    batch["pixel_values"] = ((canvas[None].astype(np.float32) / 255.0) - 0.5) / 0.5
    batch["patch_hw"] = np.asarray(hw, np.int32)[None]

    module = JaxClassifier(cfg, num_labels=num_labels, model_type=model_type)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jb))
    tree = _numpy_tree(shapes["params"], 4)
    ref = np.asarray(jax.jit(lambda p, b: module.apply({"params": p}, b))(tree, jb))

    pcfg = surgery.reallocate_text_image({}, port_cfg_from_args(TINY, False), max_len)[1]
    model = ViltClassifier(pcfg, num_labels, model_type)
    model.load_state_dict(state_dict_from_jax(tree))
    with torch.no_grad():
        out = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == ref.shape == (4, num_labels)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


# ---- the long-sequence attention ---------------------------------------------------


def _long_qkv(dtype=np.float32):
    rng = np.random.RandomState(2)
    b, s, h, d = 2, 300, 2, 64  # pads to 384: 3 x 3 blocks of 128
    q, k, v, g = (rng.randn(b, s, h, d).astype(dtype) * 0.5 for _ in range(4))
    mask = (rng.rand(b, s) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    return q, k, v, g, mask


@pytest.fixture
def blocked(monkeypatch):
    """JAX takes ``_fwd_kernel_blocked`` and ``_bwd_blockwise_xla`` above 128 keys."""
    monkeypatch.setattr(pa, "WHOLE_SEQ_MAX", 128)
    monkeypatch.setattr(pa, "BLOCK_Q", 128)
    monkeypatch.setattr(pa, "BLOCK_K", 128)


def test_long_sequence_forward_matches_blocked_kernel(blocked, monkeypatch):
    q, k, v, _, mask = _long_qkv()
    calls = []
    real = pa._fa_fwd_blocked
    monkeypatch.setattr(pa, "_fa_fwd_blocked", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = np.asarray(pa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jax_mask_to_bias(jnp.asarray(mask))))
    assert calls  # the blocked kernel ran
    t = torch.from_numpy
    out = attention.attention_fwd(t(q), t(k), t(v), attention.mask_to_bias(t(mask)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


# (atol, rtol) against _bwd_blockwise_xla: in f32 the gradient tolerance of
# tests/test_pallas_kernels.py's blocked case; in bf16 the blockwise path keeps
# P and dS in f32 and takes delta = rowsum(dO o O), where the port keeps
# _bwd_kernel's roundings (P and dS to bf16, delta = rowsum(dP o P)) at every
# S: 1-2 bf16 ulps of the largest values (|dv| <= 0.134 here, ulp 2^-10 at
# 0.125; 4.9e-4 seen), and one ulp (2^-7 relative) of any output
BLOCKWISE_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (1e-3, 2.0 ** -7)}


def _long_backward_against_blockwise(monkeypatch, dtype):
    q, k, v, g, mask = _long_qkv()
    calls = []
    real = pa._bwd_blockwise_xla
    monkeypatch.setattr(pa, "_bwd_blockwise_xla",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    jq, jk, jv, jg = (jnp.asarray(x).astype(dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, jbias), jq, jk, jv)
    ref = vjp(jg)
    assert calls
    tq, tk, tv, tg = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v, g))
    got = attention.attention_bwd(tq, tk, tv, attention.mask_to_bias(torch.from_numpy(mask)), tg)
    atol, rtol = BLOCKWISE_TOL[dtype]
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg="d" + name)


def test_long_sequence_backward_matches_blockwise_xla(blocked, monkeypatch):
    _long_backward_against_blockwise(monkeypatch, "float32")


def test_long_sequence_backward_matches_blockwise_xla_bf16(blocked, monkeypatch):
    """The bf16 case: the contract the bf16 CUDA backward is held to at
    S > 1024, where JAX takes the blockwise path."""
    _long_backward_against_blockwise(monkeypatch, "bfloat16")


def test_fully_masked_row_is_uniform():
    """Every key at -1e9: the softmax is uniform, forward and backward (the
    CUDA backward keeps the row max and 1/sum apart for this; chip_smoke.py
    holds it to this plain version on the card)."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32)) for _ in range(4))
    bias = attention.mask_to_bias(torch.zeros(1, 9))
    out = attention.attention_fwd(q, k, v, bias)
    np.testing.assert_allclose(out.numpy(), v.mean(1, keepdim=True).expand_as(v).numpy(),
                               atol=1e-6)
    dq, dk, dv = attention.attention_bwd(q, k, v, bias, g)
    np.testing.assert_allclose(dv.numpy(), g.mean(1, keepdim=True).expand_as(g).numpy(),
                               atol=1e-6)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()


# ---- load_encoder_params ------------------------------------------------------------


def test_load_encoder_params_layouts_and_nlvr2_rule(core_tree, tmp_path):
    _, tree = core_tree
    sd = state_dict_from_jax(tree)
    pcfg = port_cfg_from_args(TINY, False)
    scratch, cfg = load_encoder_params(None, pcfg, "scratch", seed=3)
    again, _ = load_encoder_params(None, pcfg, "scratch", seed=3)
    assert cfg.modality_type_vocab_size == 2 and scratch.keys() == sd.keys()
    assert all(torch.equal(scratch[k], again[k]) for k in sd)  # the seed decides

    learner_sd = {"vilt." + k: v for k, v in sd.items()}
    files = {"encoder": reference_from_state_dict(learner_sd, "encoder"),
             "model": reference_from_state_dict(learner_sd, "model")}
    for name, payload in files.items():
        torch.save(payload, tmp_path / name)
    save_state_dict(learner_sd, str(tmp_path / "port_model"))
    save_state_dict(sd, str(tmp_path / "port_core"))
    for name in ("encoder", "model", "port_model", "port_core"):
        got, _ = load_encoder_params(str(tmp_path / name), pcfg, "scratch", seed=3)
        assert all(torch.equal(got[k], sd[k]) for k in sd), name

    # 'nlvr2' in the checkpoint's path: three modality rows; a two-row file
    # leaves the table at its initialization, as partial_load does in JAX
    d = tmp_path / "task1_nlvr2"
    d.mkdir()
    torch.save(files["encoder"], d / "encoder")
    got, cfg3 = load_encoder_params(str(d / "encoder"), pcfg, "scratch", seed=3)
    assert cfg3.modality_type_vocab_size == 3
    assert got["modality_type_embeddings.weight"].shape[0] == 3
    assert torch.equal(got["pooler.weight"], sd["pooler.weight"])
    # a pretrained two-row file grows its third row from the image row
    got, _ = load_encoder_params(str(tmp_path / "nlvr2-missing"), pcfg,
                                 str(tmp_path / "encoder"), seed=3)
    mod = sd["modality_type_embeddings.weight"]
    assert torch.equal(got["modality_type_embeddings.weight"], torch.cat([mod, mod[1:2]]))

    # a hub name with no snapshot in the local cache: the seed's weights, with a
    # warning, as JAX's from_pretrained failure leaves them (snapshots:
    # tests/test_torch_pretrained.py)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
        got, _ = load_encoder_params(None, pcfg, "dandelin/vilt-b32-mlm", seed=3)
    base, _ = load_encoder_params(None, pcfg, "scratch", seed=3)
    assert all(torch.equal(got[k], base[k]) for k in base)
    # ViLT-BERT from a ViLT encoder file: the ViLT side is grafted and BERT
    # keeps the seed's weights (JAX model_factory.py:225-240)
    got, _ = load_encoder_params(str(tmp_path / "encoder"), pcfg, "scratch", seed=3,
                                 encoder_name="viltbert")
    base, _ = load_encoder_params(None, pcfg, "scratch", seed=3, encoder_name="viltbert")
    assert got.keys() == base.keys() == {"vilt." + k for k in sd} | {
        k for k in base if k.startswith("bert.")}
    assert all(torch.equal(got["vilt." + k], sd[k]) for k in sd)
    assert all(torch.equal(got[k], base[k]) for k in base if k.startswith("bert."))


# ---- the driver -----------------------------------------------------------------------

RUNS = {
    "sst2": ["--task_name", "sst2", "--task_config_overrides", "sst2.num_epochs=2,sst2.lr=1e-3"],
    "piqa": ["--task_name", "piqa", "--task_config_overrides", "piqa.num_epochs=2,piqa.lr=1e-3",
             "--eval_every_epoch"],
    "sst2-len80": ["--task_name", "sst2", "--max_len_override", "80", "--task_config_overrides",
                   "sst2.num_epochs=1,sst2.lr=1e-3"],
}


def _argv(out_dir, run):
    return ["--encoder_name", "vilt", "--checkpoint_name", "scratch",
            "--pretrained_model_name", "scratch", "--synthetic", "--tiny",
            "--synthetic_train_size", "24", "--batch_size", "8", "--seed", "5",
            "--num_shot", "16", "--subsample_seed", "10", "--output_dir", str(out_dir),
            *RUNS[run]]


@pytest.mark.parametrize("run", list(RUNS))
def test_language_driver_matches_jax(run, tmp_path, monkeypatch):
    """The results JSON of both drivers. The port's classifier starts from the
    JAX driver's initial parameters (recorded here as the JAX driver hands them
    to its training loop). The multi-choice head's dropout draws from different
    generators in the two packages, so it is off in both."""
    made = {}
    jax_train, port_train = jax_downstream.train_downstream, port.train_downstream

    def jax_recording(args, module, params, *a, **kw):
        made["params"] = jax.tree_util.tree_map(np.asarray, params)
        return jax_train(args, module, params, *a, **kw)

    def port_from_jax(args, model, *a, **kw):
        model.load_state_dict(state_dict_from_jax(made["params"]))
        made["seq_len"] = model.cfg.seq_len
        return port_train(args, model, *a, **kw)

    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    monkeypatch.setattr(jax_downstream, "train_downstream", jax_recording)
    monkeypatch.setattr(port, "train_downstream", port_from_jax)
    monkeypatch.setattr(jax_vilt, "MultiChoiceHead",
                        functools.partial(jax_vilt.MultiChoiceHead, dropout_rate=0.0))
    monkeypatch.setattr(heads.MultiChoiceHead, "dropout_rate", 0.0)

    jax_main(_argv(tmp_path / "jax", run))
    out_fn = port.main(_argv(tmp_path / "port", run) + ["--device", "cpu"])
    name = f"{RUNS[run][1]}_scratch_results.json"
    assert Path(out_fn) == tmp_path / "port" / name
    ref = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads(Path(out_fn).read_text())
    assert got.keys() == ref.keys() == {"nshot-16"}
    test, dev, epoch = got["nshot-16"]["seed-10"]
    rtest, rdev, repoch = ref["nshot-16"]["seed-10"]
    assert epoch == repoch
    # the same predictions on the same examples: equal scores
    np.testing.assert_allclose([test, dev], [rtest, rdev], atol=1e-9)
    # sst2 keeps 40 text slots and the tiny 64x96 canvas; max_len 80 (piqa's own, or the
    # override) reallocates: 80 text slots and a 128x128 image
    assert made["seq_len"] == (40 + 1 + 6 if run == "sst2" else 80 + 1 + 16)


@pytest.mark.parametrize("flags,match", [
    (["--no_synthetic"], "imdb_train.jsonl"),
    # these four raised "not ported" in earlier slices; they now run (the ids keep the
    # old expectation): a hub name not in the local cache keeps the seed's weights with
    # a warning, --scan_unroll changes nothing on the port's layer loop, and the
    # scale-out flags change nothing in a Phase II driver (one process, no mesh, as
    # the JAX driver), which says so in one line
    (["--pretrained_model_name", "dandelin/vilt-b32-mlm"], "not ported"),
    (["--scan_unroll", "2"], "not ported"),
    (["--use_mesh"], "not ported"),
    (["--n_model", "2"], "not ported"),
])
def test_unported_language_flags_raise(flags, match, tmp_path, monkeypatch, caplog):
    argv = _argv(tmp_path, "sst2") + ["--device", "cpu"]
    error = NotImplementedError
    if flags == ["--no_synthetic"]:
        # real data: imdb is read from local jsonl files only, and its task
        # config names no directory for them
        argv.remove("--synthetic")
        argv[argv.index("sst2")] = "imdb"
        error = FileNotFoundError
    elif flags[0] in argv:
        argv[argv.index(flags[0]) + 1] = flags[1]
    else:
        argv += flags
    if flags[0] != "--no_synthetic":
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
        with caplog.at_level("WARNING"):
            port.main(argv)
        assert ("no local snapshot or file" in caplog.text) == (
            flags[0] == "--pretrained_model_name")
        assert ("these flags change nothing: " + " ".join(flags) in caplog.text) == (
            flags[0] in ("--use_mesh", "--n_model"))
        assert list(tmp_path.rglob("*results.json"))
        return
    with pytest.raises(error, match=match):
        port.main(argv)


def test_language_driver_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.main(_argv(tmp_path, "sst2"))  # --device defaults to cuda


def test_new_modules_import_no_jax_package():
    """The modules of this path import torch and the port only (exact
    top-level names: ``climb_tpu_torch`` is not ``climb_tpu``), and no
    transformers."""
    new = ["ops/block.py", "models/surgery.py", "data/mean_image.py", "data/image_pipeline.py",
           "configs/model_configs.py", "train/downstream.py", "cli/train_language.py",
           "cli/train_lowshot_multimodal.py", "cli/train_vision.py", "data/vision/__init__.py",
           "data/vision/datasets.py", "data/language/__init__.py",
           "data/language/text_processors.py", "data/language/text_dataset.py",
           "models/bert.py", "models/viltbert.py", "models/hf_import.py",
           "train/model_factory.py", "ckpt/convert.py"]
    for rel in new:
        path = ROOT / "climb_tpu_torch" / rel
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            roots = []
            if isinstance(node, ast.Import):
                roots = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            assert not set(roots) & {"jax", "flax", "optax", "climb_tpu", "transformers"}, \
                (rel, roots)
