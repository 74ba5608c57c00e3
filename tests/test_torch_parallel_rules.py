"""climb_tpu_torch's scale-out rules against the JAX package's, on the CPU.

- ``parallel.sharding.param_spec`` against ``climb_tpu.parallel.sharding
  .param_spec`` for every parameter of the tiny learner (plain, with houlsby
  adapters, with LoRA, ViLT-BERT), for tensor parallelism, FSDP over 2 and 4
  data ranks and the pipeline layout: the port's spec, mapped to the JAX
  leaf's layout (stacked layer axis first, Dense kernels (in, out)), must be
  JAX's spec of that leaf;
- ``parallel.pipeline.pipeline_schedule`` and ``interleave_for_pipeline``
  against JAX's over a grid of (microbatches, stages, virtual stages);
- the loader's node stripes against JAX's ``DataLoader(host_id=,
  host_count=)``, and the data ranks' shares of a node's batch;
- the mesh's rank order and groups in a 4-rank gloo world.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from climb_tpu.configs import task_configs as jax_task_configs
from climb_tpu.data.collation import stack_collate as jax_collate
from climb_tpu.data.loader import DataLoader as JaxLoader
from climb_tpu.parallel import pipeline as jax_pipeline
from climb_tpu.parallel.sharding import param_spec as jax_param_spec
from climb_tpu.train.model_factory import create_cl_model as jax_create
from climb_tpu_torch.ckpt.convert import jax_leaf, state_dict_from_jax
from climb_tpu_torch.data.loader import DataLoader
from climb_tpu_torch.parallel import pipeline
from climb_tpu_torch.parallel.sharding import param_spec, stack_depths, _stack_of, to_jax_spec
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)

LEARNERS = [("vilt", None), ("vilt", "houlsby"), ("vilt", "lora"), ("viltbert", None)]


def _jax_params(encoder, adapter):
    args = SimpleNamespace(batch_size=8, seed=0, ordered_cl_tasks=["snli-ve", "nlvr2"],
                           encoder_name=encoder, pretrained_model_name="scratch", tiny=True,
                           synthetic=True, image_height=64, image_width=96)
    handler = None
    if adapter:
        from climb_tpu.cl.adapters import AdapterHandler

        args.adapter_config = adapter
        args.adapter_reduction_factor = 2
        args.lora_rank = 2 if adapter == "lora" else 0
        args.lora_alpha = 4.0 if adapter == "lora" else 0.0
        args.lora_targets = "q,v,fc1,attn_out" if adapter == "lora" else ""
        handler = AdapterHandler("vanilla", args)
    return jax.tree_util.tree_map(np.asarray, jax_create(args, jax_task_configs,
                                                         adapter_handler=handler).params)


def _jax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class _Key:
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("encoder,adapter", LEARNERS,
                         ids=[f"{e}-{a or 'plain'}" for e, a in LEARNERS])
def test_param_spec_matches_jax(encoder, adapter):
    tree = _jax_params(encoder, adapter)
    sd = state_dict_from_jax(tree)
    leaves = dict(_jax_leaves(tree))
    depths = stack_depths(sd)
    seen = set()
    for fsdp_size, pp in ((0, False), (2, False), (4, False), (0, True)):
        for name, t in sd.items():
            path, _, _ = jax_leaf(name, tuple(t.shape))
            leaf = leaves[path]
            want = tuple(jax_param_spec(tuple(_Key(k) for k in path), leaf, fsdp_size, pp=pp))
            spec = param_spec(name, tuple(t.shape), depths.get(_stack_of(name), 0), fsdp_size,
                              pp)
            got = to_jax_spec(spec, name, tuple(t.shape))
            assert got == want, (name, fsdp_size, pp, got, want)
            seen.add(path)
    assert seen == set(leaves)  # every JAX leaf has its port tensors


@pytest.mark.parametrize("M,P,V", [(m, p, v) for m in (1, 2, 3, 4, 5, 8) for p in (1, 2, 4)
                                   for v in (1, 2, 3)])
def test_pipeline_schedule_matches_jax(M, P, V):
    n, tables = pipeline.pipeline_schedule(M, P, V)
    jn, jtables = jax_pipeline.pipeline_schedule(M, P, V)
    assert n == jn
    assert tables.keys() == jtables.keys()
    for k in tables:
        np.testing.assert_array_equal(tables[k], jtables[k], err_msg=k)


@pytest.mark.parametrize("L,P,V", [(4, 2, 1), (4, 2, 2), (8, 2, 2), (8, 4, 2), (12, 2, 3)])
def test_interleave_matches_jax(L, P, V):
    got = pipeline.interleave_for_pipeline(list(range(L)), P, V)
    want = np.asarray(jax_pipeline.interleave_for_pipeline({"x": np.arange(L)}, P, V)["x"])
    assert got == want.tolist()


class _Indexed:
    """Examples that carry their own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i, np.int64), "x": np.full((3,), i, np.float32)}


def _collate(examples):
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


@pytest.mark.parametrize("n,bs,hosts", [(37, 4, 2), (40, 8, 4), (13, 4, 3)])
def test_loader_stripes_match_jax(n, bs, hosts):
    ds = _Indexed(n)
    for host in range(hosts):
        kw = dict(shuffle=True, seed=3, epoch=2, num_workers=1, host_id=host,
                  host_count=hosts)
        got = list(DataLoader(ds, bs, _collate, **kw))
        want = list(JaxLoader(ds, bs, jax_collate, **kw))
        assert len(got) == len(want) == len(DataLoader(ds, bs, _collate, **kw))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["idx"], w["idx"])
            np.testing.assert_array_equal(g["valid"], w["valid"])


def test_data_rank_shares_split_the_node_batch():
    """Each data rank loads its contiguous share of every node batch (the
    last, partial one too: a share past the real rows is all padding), and
    the shares in rank order are the node's batch."""
    ds, bs = _Indexed(21), 8
    kw = dict(shuffle=True, seed=1, epoch=1, num_workers=1)
    whole = list(DataLoader(ds, bs, _collate, **kw))
    shares = [list(DataLoader(ds, bs, _collate, shard=(i, 4), **kw)) for i in range(4)]
    assert all(len(s) == len(whole) for s in shares)
    for b, batch in enumerate(whole):
        parts = [s[b] for s in shares]
        valid = np.concatenate([p["valid"] for p in parts])
        np.testing.assert_array_equal(valid, batch["valid"])
        real = np.concatenate([p["idx"][p["valid"] > 0] for p in parts])
        np.testing.assert_array_equal(real, batch["idx"][batch["valid"] > 0])
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(ds, 6, _collate, shard=(0, 4))


def test_mesh_rank_order_and_groups(tmp_path):
    """Rank r holds the coordinate device r holds in JAX's row-major mesh
    array, and each axis's group sums over exactly its ranks."""
    out = worker.spawn("mesh", 4, str(tmp_path), {})
    assert out["coords"] == [list(np.argwhere(np.arange(4).reshape(2, 2) == r)[0])
                             for r in range(4)]
    # rank r contributes r + 1: 'data' pairs ranks r and r + 2, 'model' r and r ^ 1
    assert out["data_sums"] == [4.0, 6.0, 4.0, 6.0]
    assert out["model_sums"] == [3.0, 3.0, 7.0, 7.0]
    assert out["multislice"] == {"replica": 2, "data": 2, "model": 1}
