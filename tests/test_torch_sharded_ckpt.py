"""climb_tpu_torch's sharded and asynchronous checkpoints, and the Phase I
driver on a mesh, on the CPU.

- The port reads a sharded task checkpoint that the JAX package saved from
  parameters sharded FSDP x TP on a 2 x 4 mesh (``model`` and ``encoder``),
  and a JAX bf16 tree, bit for bit.
- The JAX package's ``load_params`` and ``load_sharded`` read a task
  checkpoint and a train state with bf16 first moments that a 2 x 2 (FSDP x
  TP) port world wrote (each rank its own slices), bit for bit; a 4-rank
  world, one rank, and JAX's ``load_sharded`` onto a 2 x 4 mesh read the
  checkpoint back too (resharding); one missing a rank's files is refused.
- ``AsyncCheckpointWriter`` keeps each path's writes in order and re-raises
  a writer's error at ``flush``; an ``--async_checkpoint`` run (also with
  ``--sharded_checkpoints``) stopped after its first epoch resumes to the
  uninterrupted run's parameters bit for bit.
- The Phase I driver over a 2-rank gloo world with ``--use_mesh --fsdp
  --sharded_checkpoints`` writes the single-process run's results and
  parameters.
"""

import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ckpt import checkpoint as jax_ckpt
from climb_tpu.ckpt import sharded as jax_sharded
from climb_tpu.configs import task_configs as jax_task_configs
from climb_tpu.parallel.mesh import make_mesh
from climb_tpu.parallel.sharding import param_sharding_rules, shard_params
from climb_tpu.train.model_factory import create_cl_model as jax_create
from climb_tpu_torch.ckpt import checkpoint, sharded
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.train import trainers
from tests import torch_parallel_worker as worker
from tests.test_torch_data_common import jit_flax_init

torch.set_num_threads(1)

TASKS = ["snli-ve", "nlvr2"]


@pytest.fixture(scope="module")
def jax_params():
    with pytest.MonkeyPatch.context() as mp:
        jit_flax_init(mp)
        args = SimpleNamespace(batch_size=8, seed=0, ordered_cl_tasks=TASKS,
                               encoder_name="vilt", pretrained_model_name="scratch", tiny=True,
                               synthetic=True, image_height=64, image_width=96)
        return jax.tree_util.tree_map(np.asarray, jax_create(args, jax_task_configs).params)


def _assert_bit_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_port_reads_jax_fsdp_checkpoint(jax_params, tmp_path):
    mesh = make_mesh(n_data=2, n_model=4)
    placed = shard_params(jax.tree_util.tree_map(jnp.asarray, jax_params), mesh, fsdp=True)
    jax_ckpt.save_task_checkpoint(str(tmp_path), 0, "snli-ve", placed, sharded=True)
    d = checkpoint.task_dir(str(tmp_path), 0, "snli-ve")
    assert checkpoint.task_checkpoint_exists(str(tmp_path), 0, "snli-ve")
    want = state_dict_from_jax(jax_params)
    got = checkpoint.load_task_checkpoint(str(tmp_path), 0, "snli-ve")
    _assert_bit_equal(got, want)
    # row-major, as the kernels take them (the forgetting eval hands loaded
    # tensors to the model without copying them into its parameters)
    assert all(t.is_contiguous() for t in got.values())
    enc = checkpoint.load_state_dict(os.path.join(d, "encoder"))
    _assert_bit_equal(enc, {k[len("vilt."):]: v for k, v in want.items()
                            if k.startswith("vilt.")})
    bf16 = np.random.RandomState(0).randn(8, 6).astype(jnp.bfloat16)
    jax_sharded.save_sharded({"m": jnp.asarray(bf16)}, str(tmp_path / "tree"))
    flat, _ = sharded.load_sharded(str(tmp_path / "tree"))
    assert flat["m"].dtype == torch.bfloat16
    assert np.array_equal(flat["m"].view(torch.uint16).numpy(), bf16.view(np.uint16))


@pytest.fixture(scope="module")
def port_saved(jax_params, tmp_path_factory):
    """A task checkpoint and a train state written by a 2 x 2 FSDP x TP port
    world (the model from the JAX weights), and the state's whole moments."""
    from tests.test_mesh_training_equivalence import synthetic_batches

    d = tmp_path_factory.mktemp("port_saved")
    case = dict(task="snli-ve", encoder="vilt", adapter=None, tasks=TASKS,
                state_dict=state_dict_from_jax(jax_params),
                batches=[{k: np.asarray(v) for k, v in synthetic_batches("snli-ve", 1)[0].items()}])
    moments = worker.spawn("save_sharded", 4, str(d / "world"), dict(
        layout=dict(n_model=2, fsdp=True), case=case, out_dir=str(d / "out"),
        state_dir=str(d / "state")))
    return d, moments


def test_jax_reads_port_checkpoint_from_four_ranks(jax_params, port_saved):
    d, moments = port_saved
    model_dir = os.path.join(checkpoint.task_dir(str(d / "out"), 0, "snli-ve"), "model")
    assert sorted(os.listdir(model_dir)) == sorted(
        f"{kind}-{r}.{ext}" for r in range(4) for kind, ext in (("manifest", "json"),
                                                                 ("shards", "npz")))
    with open(os.path.join(model_dir, "manifest-1.json")) as f:
        rank1 = json.load(f)["leaves"]
    # rank 1 (data 0, model 1) holds its heads' columns of every q kernel
    assert [c["start"] for c in rank1["vilt/encoder/q/kernel"]["chunks"]] == [[0, 0, 32],
                                                                              [1, 0, 32]]
    with open(os.path.join(model_dir, "manifest-2.json")) as f:
        rank2 = json.load(f)["leaves"]  # data 1, model 0: its rows of the word table
    assert [c["start"] for c in rank2["vilt/word_embeddings"]["chunks"]] == [[1024, 0]]
    got = jax_ckpt.load_params(model_dir)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert np.asarray(flat_got[k]).dtype == v.dtype and np.array_equal(flat_got[k], v), k
    state, _ = jax_sharded.load_sharded(str(d / "state"))
    assert int(state["state"]["step"]) == moments["step"] == 1
    for group in ("mu", "nu"):
        assert state["state"][group].keys() == moments[group].keys()
        for name, want in moments[group].items():
            got = np.asarray(state["state"][group][name])
            assert str(got.dtype) == ("bfloat16" if group == "mu" else "float32"), name
            assert np.array_equal(got.view(np.uint16 if group == "mu" else np.uint32),
                                  want.view(torch.uint16 if group == "mu" else torch.int32)
                                  .numpy().view(np.uint16 if group == "mu" else np.uint32)), name
    assert torch.count_nonzero(moments["mu"]["vilt.word_embeddings.weight"]) > 0


def test_reshard_onto_another_world(jax_params, port_saved):
    d, _ = port_saved
    model_dir = os.path.join(checkpoint.task_dir(str(d / "out"), 0, "snli-ve"), "model")
    got = worker.spawn("load_sharded", 2, str(d / "world2"), dict(path=model_dir))
    _assert_bit_equal(got, state_dict_from_jax(jax_params))
    _assert_bit_equal(checkpoint.load_model_file(model_dir), state_dict_from_jax(jax_params))
    mesh = make_mesh(n_data=2, n_model=4)
    rules = param_sharding_rules(jax.tree_util.tree_map(jnp.asarray, jax_params), mesh,
                                 fsdp=True)
    tree, _ = jax_sharded.load_sharded(model_dir, shardings=rules)
    for (path, leaf), want in zip(jax.tree_util.tree_leaves_with_path(tree),
                                  jax.tree_util.tree_leaves(jax_params)):
        assert np.array_equal(np.asarray(leaf), want), path


def test_incomplete_checkpoint_is_refused(port_saved, tmp_path):
    d, _ = port_saved
    src = os.path.join(checkpoint.task_dir(str(d / "out"), 0, "snli-ve"), "model")
    cut = tmp_path / "model"
    shutil.copytree(src, cut)
    os.remove(cut / "shards-1.npz")
    os.remove(cut / "manifest-1.json")
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        checkpoint.load_model_file(str(cut))
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        jax_ckpt.load_params(str(cut))


def test_async_writer_orders_and_reraises(tmp_path):
    writer = checkpoint.AsyncCheckpointWriter()
    path = str(tmp_path / "state")
    for i in range(5):
        writer.submit({"i": torch.tensor(i)}, path)
    writer.flush()
    assert int(torch.load(path, weights_only=True)["i"]) == 4
    blocked = tmp_path / "file"
    blocked.write_text("")
    writer.submit({"i": torch.tensor(0)}, str(blocked / "state"))  # its directory is a file
    with pytest.raises(OSError):
        writer.flush()
    writer.close()


def _argv(out, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", str(out), "--synthetic", "--tiny", "--synthetic_train_size",
            "24", "--batch_size", "8", "--seed", "5", "--task_config_overrides",
            "snli-ve.num_epochs=3,snli-ve.lr=2e-3", "--output_dir", str(out),
            "--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft", "--do_train",
            "--device", "cpu", "--num_workers", "1", *extra]


def _params(out, task="snli-ve", n=0):
    exp = next(p for p in out.iterdir() if p.is_dir())
    return checkpoint.load_task_checkpoint(str(exp), n, task)


@pytest.mark.parametrize("flags", [["--async_checkpoint"],
                                   ["--async_checkpoint", "--sharded_checkpoints"]],
                         ids=["async", "async_sharded"])
def test_async_checkpoint_resume_equals_uninterrupted(flags, tmp_path, monkeypatch):
    """The run dies in epoch 2 (an error in a train step); the epoch-1 state
    written behind the loop is whole, and the rerun ends on the
    uninterrupted run's parameters."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    port.main(_argv(whole, *flags))
    make = trainers.make_step_dispatcher
    count = [0]

    def dying(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            count[0] += 1
            if count[0] == 5:  # epoch 2, step 2 of 3
                raise RuntimeError("the machine went away")
            return step(*sa, **skw)
        return run

    monkeypatch.setattr(trainers, "make_step_dispatcher", dying)
    with pytest.raises(RuntimeError, match="went away"):
        port.main(_argv(cut, *flags))
    exp = next(p for p in cut.iterdir() if p.is_dir())
    state = exp / "checkpoints" / "task0_snli-ve" / "train_state"
    assert state.is_dir() == ("--sharded_checkpoints" in flags) and state.exists()
    monkeypatch.undo()
    port.main(_argv(cut, *flags))
    assert not state.exists()
    _assert_bit_equal(_params(cut), _params(whole))


def test_two_rank_driver_equals_single_process(tmp_path):
    single, mesh = tmp_path / "single", tmp_path / "mesh"
    tasks = ["--ordered_cl_tasks", "snli-ve,nlvr2", "--cl_algorithm", "sequential_ft",
             "--task_config_overrides",
             "snli-ve.num_epochs=2,nlvr2.num_epochs=1,snli-ve.lr=1e-3,nlvr2.lr=1e-3",
             "--synthetic_train_size", "32", "--do_eval"]
    argv = lambda out, *extra: [a for a in _argv(out)] + tasks + list(extra)
    port.main(argv(single))
    worker.spawn("driver", 2, str(tmp_path / "world"), dict(argv=argv(
        mesh, "--use_mesh", "--fsdp", "--sharded_checkpoints")), timeout=240)
    exp = "vilt-sequential_ft-task0_snli-ve-task1_nlvr2"
    for name in ("results.json", "eval_results.json"):
        assert json.loads((single / exp / name).read_text()) == \
            json.loads((mesh / exp / name).read_text()), name
    ckpt = mesh / exp / "checkpoints" / "task1_nlvr2" / "model"
    assert ckpt.is_dir() and (ckpt / "manifest-1.json").exists()
    got, want = _params(mesh, "nlvr2", 1), _params(single, "nlvr2", 1)
    assert set(got) == set(want)
    # 16 AdamW steps of lr 1e-3; the ranks' gradient sums run in another order,
    # and the key biases (exact gradient 0) step on rounding noise
    for k in want:
        atol = 2 * 16 * 1e-3 if k.endswith(".k.bias") else 1e-4
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=1e-4,
                                   err_msg=k)
