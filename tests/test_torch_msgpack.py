"""The JAX package's flax msgpack checkpoints read by climb_tpu_torch on the
CPU.

Files written by ``flax.serialization.msgpack_serialize`` (f32, bf16, int32,
bool and f16 arrays, numpy and Python scalars, nested dicts, a chunked array
forced by a small chunk size) and by the JAX package's
``save_task_checkpoint`` (a learner's ``model`` and ``encoder``, adapters
included) are read bit for bit by the port's own decoder, which imports no
``msgpack``, ``flax`` or ``ml_dtypes``. A Phase II encoder loaded by the
port from a JAX Phase I ``encoder`` file equals the JAX package's
``load_encoder_params``, gives the JAX encoder's outputs, and the port's
language driver runs from it. The JAX elastic ``train_state``, in both
layouts, at an epoch's end and mid-epoch, with and without the non-finite
guard (``tests/torch_resume_common.py``), loads into the port's
``TrainState`` with the parameters, AdamW moments, update count and guard
counters of the JAX package's own ``load_train_state`` bit for bit (which
reads the msgpack layout only); a tree
whose optimizer chain does not fit the run raises ``ValueError`` naming the
path.
"""

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from climb_tpu.ckpt.checkpoint import save_task_checkpoint as jax_save_task_checkpoint
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltCore as JaxCore
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.model_factory import load_encoder_params as jax_load_encoder_params
from climb_tpu_torch.ckpt import checkpoint, convert
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import train_language
from climb_tpu_torch.models.vilt_core import ViltCore
from climb_tpu_torch.train.model_factory import load_encoder_params, vilt_config_from_args
from test_torch_data_common import shape_only_flax_init
import torch_resume_common as resume

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4  # f32 forward tolerance of tests/test_torch_port_model.py
TASKS = ["snli-ve", "nlvr2"]


def _bits(x):
    """An array's bytes (bf16 tensors as their uint16 words), for bit equality."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_flax_msgpack_values_read_bit_equal(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    bf16 = np.asarray(jnp.asarray(rng.randn(3, 5), jnp.bfloat16))
    tree = {
        "f32": rng.randn(4, 3).astype(np.float32),
        "nested": {"i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
                   "bool": np.array([True, False, True]),
                   "f16": rng.randn(6).astype(np.float16),
                   "bf16": bf16, "bf16_scalar": np.asarray(jnp.bfloat16(1.5))[()],
                   "deeper": {"empty": {}, "u8": np.arange(200, 256, dtype=np.uint8)}},
        "scalars": {"np_f32": np.float32(2.5), "np_i64": np.int64(-7), "int": 3, "neg": -70000,
                    "big": 2 ** 40, "float": 0.125, "none": None, "true": True, "str": "s" * 40,
                    "complex": complex(1.0, -2.0), "list": [1, 2, 3]},
        "chunked": rng.randn(3, 7).astype(np.float32),
        "chunked_bf16": np.asarray(jnp.asarray(rng.randn(9), jnp.bfloat16)),
    }
    # flax chunks arrays above MAX_CHUNK_SIZE bytes: force it for the two
    # "chunked" leaves (84 and 18 bytes) and no other
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    blob = serialization.msgpack_serialize({k: tree[k] for k in ("chunked", "chunked_bf16")})
    monkeypatch.undo()
    assert b"__msgpack_chunked_array__" in blob
    small = serialization.msgpack_serialize({k: v for k, v in tree.items()
                                             if not k.startswith("chunked")})
    for name, data in (("chunked", blob), ("plain", small)):
        (tmp_path / name).write_bytes(data)
    got = {**checkpoint.read_flax_msgpack(str(tmp_path / "plain")),
           **checkpoint.read_flax_msgpack(str(tmp_path / "chunked"))}

    def check(g, w, path):
        if isinstance(w, dict):
            assert isinstance(g, dict) and g.keys() == w.keys(), path
            for k in w:
                check(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, np.ndarray) and w.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16, path
            assert tuple(g.shape) == w.shape and _bits(g) == w.view(np.int16).tobytes(), path
        elif isinstance(w, (np.ndarray, np.generic)) and w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16 and float(g) == float(w), path
        elif isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert _bits(g) == _bits(w), path
        else:
            assert g == w and type(g) is type(w), path

    check(got, tree, "")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX learner (snli-ve and nlvr2 heads, houlsby adapters), every leaf
    from numpy, saved by the JAX package as task 1 (nlvr2) of a Phase I run."""
    from climb_tpu.cl.adapters import AdapterHandler as JaxAdapterHandler

    args = SimpleNamespace(ordered_cl_tasks=TASKS, encoder_name="vilt", tiny=True, seed=2,
                           pretrained_model_name="scratch", image_height=64, image_width=96,
                           adapter_config="houlsby", adapter_reduction_factor=8)
    with pytest.MonkeyPatch.context() as mp:
        shape_only_flax_init(mp)
        model = jax_create_cl_model(args, jax_task_configs,
                                    adapter_handler=JaxAdapterHandler("vanilla", args))
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32),
                                  model.params)
    out = tmp_path_factory.mktemp("jax_run")
    jax_save_task_checkpoint(str(out), 1, "nlvr2", tree)
    return out / "checkpoints" / "task1_nlvr2", tree


def test_jax_task_checkpoint_reads_bit_equal(jax_run):
    ckpt, tree = jax_run
    want = state_dict_from_jax(tree)
    for got in (checkpoint.load_model_file(str(ckpt / "model")),
                checkpoint.load_task_checkpoint(str(ckpt.parent.parent), 1, "nlvr2"),
                checkpoint.load_state_dict(str(ckpt / "model"))):
        assert got.keys() == want.keys()
        assert any(k.startswith("vilt.encoder.0.adapter_") for k in got)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    enc = checkpoint.load_state_dict(str(ckpt / "encoder"))
    assert enc.keys() == state_dict_from_jax(tree["vilt"]).keys()


def test_phase2_encoder_from_a_jax_checkpoint_gives_jax_outputs(jax_run):
    """``--checkpoint_name`` naming the JAX run's nlvr2 encoder file: the
    port's encoder equals the JAX package's ``load_encoder_params`` (three
    modality rows by the path's 'nlvr2') and gives the JAX encoder's outputs."""
    ckpt, _ = jax_run
    path = str(ckpt / "encoder")
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=False)
    sd, pcfg = load_encoder_params(path, cfg, "scratch", seed=3)
    jparams, jcfg = jax_load_encoder_params(path, jax_config(cfg), "scratch", seed=3)
    assert pcfg.modality_type_vocab_size == jcfg.modality_type_vocab_size == 3
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    rng = np.random.RandomState(1)
    batch = (rng.randint(1, 2048, (2, 40)).astype(np.int32),
             (np.arange(40)[None] < np.array([[30], [12]])).astype(np.float32),
             rng.randn(2, 64, 96, 3).astype(np.float32), np.array([[2, 3], [1, 2]], np.int32))
    jseq, jpooled, _ = JaxCore(jcfg).apply({"params": jparams}, *map(jnp.asarray, batch))
    core = ViltCore(pcfg)
    core.load_state_dict(sd)
    with torch.no_grad():
        seq, pooled, _ = core.eval()(*(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=ATOL, rtol=RTOL)


def jax_config(cfg):
    from climb_tpu.models import ViltConfig as JaxConfig

    return JaxConfig(**{f: getattr(cfg, f) for f in JaxConfig.__dataclass_fields__
                        if hasattr(cfg, f)})


def test_language_driver_runs_from_a_jax_checkpoint(jax_run, tmp_path):
    ckpt, _ = jax_run
    train_language.main([
        "--device", "cpu", "--task_name", "sst2", "--encoder_name", "vilt",
        "--checkpoint_name", str(ckpt / "encoder"), "--pretrained_model_name", "scratch",
        "--synthetic", "--tiny", "--synthetic_train_size", "16", "--batch_size", "8",
        "--output_dir", str(tmp_path)])
    results = list(tmp_path.glob("sst2_*_results.json"))
    assert len(results) == 1 and json.loads(results[0].read_text())


GUARDS = {"guarded": ["--skip_nonfinite_updates", "2"], "unguarded": []}


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """{guard: {(kind, layout): path}}: the JAX driver's four train states of
    a run with and without ``--skip_nonfinite_updates``."""
    return {guard: resume.jax_train_states(tmp_path_factory.mktemp(guard), *extra)
            for guard, extra in GUARDS.items()}


def _port_state(guard, tmp_path):
    """The port's TrainState for the run's command line (its own weights)."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as port_driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.optimizer import make_optimizer
    from climb_tpu_torch.train.train_state import TrainState

    args = port_driver.build_parser().parse_args(resume.argv(tmp_path, *GUARDS[guard]))
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    model = port_driver.create_cl_model(args, task_configs, torch.device("cpu"))
    tx = make_optimizer([n for n, _ in model.named_parameters()], lr=2e-3, total_steps=9,
                        skip_nonfinite=int(args.skip_nonfinite_updates))
    return TrainState.create(model, tx)


def _jax_state(guard, path, tmp_path):
    """The state as the JAX package's own ``load_train_state`` restores it."""
    from climb_tpu.ckpt.checkpoint import load_train_state as jax_load_train_state
    from climb_tpu.cli.train_upstream_continual_learning import build_parser as jax_parser
    from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from climb_tpu.train.train_state import TrainState as JaxTrainState

    args = jax_parser().parse_args(resume.argv(tmp_path, *GUARDS[guard]))
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    with pytest.MonkeyPatch.context() as mp:
        shape_only_flax_init(mp)
        model = jax_create_cl_model(args, jax_task_configs)
    tx = jax_make_optimizer(model.params, lr=2e-3, total_steps=9,
                            skip_nonfinite=int(args.skip_nonfinite_updates))
    template = JaxTrainState.create(apply_fn=model.module.apply, params=model.params, tx=tx)
    return jax_load_train_state(template, str(path))


@pytest.mark.parametrize("layout", resume.LAYOUTS)
@pytest.mark.parametrize("kind", resume.KINDS)
@pytest.mark.parametrize("guard", list(GUARDS))
def test_jax_train_state_loads_bit_equal(guard, kind, layout, jax_states, tmp_path):
    """Each layout against the msgpack file written from the same state at
    the same save, as the JAX package's ``load_train_state`` restores it:
    that function cannot restore its own sharded train state (the directory
    stores no node for the weight decay's empty ``MaskedState``, and flax's
    ``from_state_dict`` then fails at ``opt_state/.../0``), so a JAX run
    under ``--sharded_checkpoints`` restarts its task where the port
    resumes."""
    path = jax_states[guard][kind, layout]
    state = _port_state(guard, tmp_path)
    meta = checkpoint.load_train_state(state, str(path))
    jstate, jmeta = _jax_state(guard, jax_states[guard][kind, "msgpack"], tmp_path)
    if layout == "sharded":
        with pytest.raises(ValueError, match="do not match"):
            _jax_state(guard, path, tmp_path)
    opt = jstate.opt_state.inner_state if guard == "guarded" else jstate.opt_state
    adam = opt[0][0]
    trees = {"params": jstate.params, "mu": adam.mu, "nu": adam.nu}
    mu, nu = state.moments()
    for group, got in (("params", state.params), ("mu", mu), ("nu", nu)):
        for name, t in got.items():
            keys, layer, transposed = convert.jax_leaf(name, tuple(t.shape))
            leaf = trees[group]
            for k in keys:
                leaf = leaf[k]
            leaf = np.asarray(leaf if layer is None else leaf[layer])
            leaf = leaf.T if transposed else leaf
            assert _bits(t.detach().float()) == _bits(leaf.astype(np.float32)), (group, name)
    assert state.step == int(adam.count) == int(jstate.step) == (
        resume.PREEMPT_AT if kind == "mid" else 3)
    if guard == "guarded":
        assert (state.notfinite_count, state.total_notfinite) == (
            int(jstate.opt_state.notfinite_count), int(jstate.opt_state.total_notfinite))
    for key in ("epoch", "global_step", "best_epoch", "steps_into_epoch"):
        assert meta.get(key) == (int(jmeta[key]) if key in jmeta else None), key
    assert meta["best_score"] == float(jmeta["best_score"])
    assert bytes(meta["py_random"].numpy()) == bytes(np.asarray(jmeta["py_random"]))
    assert (meta["epoch"], meta.get("steps_into_epoch")) == (
        (1, 2) if kind == "mid" else (1, None))


def _misfit(jax_states, tmp_path, case):
    """A train state that does not fit the run it is loaded into: (path,
    the port's guard)."""
    if case == "guarded_state_unguarded_run":
        return jax_states["guarded"]["mid", "msgpack"], "unguarded"
    if case == "unguarded_state_guarded_run":
        return jax_states["unguarded"]["mid", "sharded"], "guarded"
    # a chain with optax.clip_by_global_norm first (make_optimizer's
    # max_grad_norm), which no trainer builds
    from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from climb_tpu.train.train_state import TrainState as JaxTrainState

    restored = serialization.msgpack_restore(
        jax_states["unguarded"]["end", "msgpack"].read_bytes())
    params = restored["state"]["params"]
    tx = jax_make_optimizer(params, lr=2e-3, total_steps=9, max_grad_norm=1.0)
    clipped = JaxTrainState.create(apply_fn=None, params=params, tx=tx)
    path = tmp_path / "clipped"
    path.write_bytes(serialization.msgpack_serialize(
        {"state": serialization.to_state_dict(clipped), "meta": restored["meta"]}))
    return path, "unguarded"


@pytest.mark.parametrize("case,where", [
    ("guarded_state_unguarded_run", "opt_state/inner_state"),
    ("unguarded_state_guarded_run", "opt_state/0"),
    ("clip_by_global_norm", "opt_state/1"),
])
def test_jax_train_state_that_does_not_fit_raises(case, where, jax_states, tmp_path):
    path, guard = _misfit(jax_states, tmp_path, case)
    state = _port_state(guard, tmp_path)
    before = {n: t.clone() for n, t in state.params.items()}
    with pytest.raises(ValueError, match=f"JAX train_state: {where} "):
        checkpoint.load_train_state(state, str(path))
    assert all(torch.equal(before[n], t) for n, t in state.params.items())  # untouched


@pytest.mark.parametrize("module", ["checkpoint.py", "convert.py"])
def test_reader_imports_no_msgpack_flax_or_ml_dtypes(module):
    src = Path(checkpoint.__file__).parent / module
    roots = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"msgpack", "flax", "ml_dtypes", "jax", "climb_tpu"}, roots
    assert "torch" in roots
