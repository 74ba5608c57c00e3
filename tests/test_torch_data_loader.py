"""The port's prefetching loader against the JAX package's: batches bit for
bit, epoch by epoch, shuffled and in order, with and without ``drop_last``,
from thread and process workers, over a synthetic split and the mini CLiMB
data root's real splits; ``set_skip``; bounded readahead; a worker's
exception reaching the consumer; and ``device_prefetch``'s order and spans on
the CPU.
All comparisons are exact.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.data.collation import stack_collate as jax_collate
from climb_tpu.data.loader import DataLoader as JaxLoader
from climb_tpu.data.loader import collate_from_indices as jax_collate_from_indices
from climb_tpu.data.synthetic import make_synthetic_vl_dataset as jax_synthetic
from climb_tpu.data.visionlanguage import build_vl_datasets as jax_build
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader, collate_from_indices, device_prefetch
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.data.visionlanguage import build_vl_datasets
from climb_tpu_torch.utils import tracing
from test_driver_real_data import climb_dir  # noqa: F401  (the mini data root)
from test_torch_data_common import copy_root, jax_native_route  # noqa: F401

CANVAS = (64, 96)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def splits(climb_dir, tmp_path_factory, jax_native_route):  # noqa: F811
    """(port dataset, JAX dataset) pairs: a synthetic nlvr2 split of 37 pairs
    and the mini root's snli-ve and nlvr2 train splits."""
    base = tmp_path_factory.mktemp("loader")
    out = {"synthetic": (
        make_synthetic_vl_dataset("nlvr2", task_configs["nlvr2"], "train", 37, 16, CANVAS, 3),
        jax_synthetic("nlvr2", jax_task_configs["nlvr2"], "train", 37, 16, CANVAS, 3))}
    for task in ("snli-ve", "nlvr2"):
        args = {pkg: SimpleNamespace(climb_data_dir=copy_root(climb_dir, base / pkg / task),
                                     image_height=CANVAS[0], image_width=CANVAS[1],
                                     max_text_len=16, tokenizer="x", vocab_path=None,
                                     visual_input_type="pil-image") for pkg in ("port", "jax")}
        for pkg in args:
            args[pkg].vocab_path = f"{args[pkg].climb_data_dir}/vocab.txt"
        out[task] = (build_vl_datasets(args["port"], task, task_configs[task])[0],
                     jax_build(args["jax"], task, jax_task_configs[task])[0])
    return out


@pytest.mark.parametrize("split,batch_size", [("synthetic", 8), ("snli-ve", 4), ("nlvr2", 3)])
@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_batches_match_jax_epoch_by_epoch(splits, split, batch_size, worker_mode):
    port_ds, jax_ds = splits[split]
    for shuffle, drop_last in ((True, False), (False, False), (True, True)):
        got = DataLoader(port_ds, batch_size, stack_collate, shuffle=shuffle, drop_last=drop_last,
                         seed=11, num_workers=2, worker_mode=worker_mode)
        want = JaxLoader(jax_ds, batch_size, jax_collate, shuffle=shuffle, drop_last=drop_last,
                         seed=11, num_workers=2, host_id=0, host_count=1)
        assert len(got) == len(want)
        for epoch in (1, 2, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert_batches_equal(list(got), list(want))
            if not shuffle:
                break


def test_set_skip_and_collate_from_indices_match_jax(splits):
    port_ds, jax_ds = splits["synthetic"]
    got = DataLoader(port_ds, 8, stack_collate, shuffle=True, seed=2, num_workers=3)
    want = JaxLoader(jax_ds, 8, jax_collate, shuffle=True, seed=2, num_workers=3, host_id=0,
                     host_count=1)
    for loader in (got, want):
        loader.set_epoch(4)
        loader.set_skip(2)
    assert_batches_equal(list(got), list(want))
    full = list(got)  # the skip holds for one iteration only
    assert len(full) == len(got) == 5
    idx = [5, 0, 36, 17]
    assert_batches_equal([collate_from_indices(port_ds, idx, stack_collate, 6)],
                         [jax_collate_from_indices(jax_ds, idx, jax_collate, 6)])


class _Recording:
    """A dataset that records which examples were loaded and can fail."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.loaded = n, fail_at, set()
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"example {i} is broken")
        with self.lock:
            self.loaded.add(i)
        return {"x": np.full((3,), i, np.int64)}


def test_readahead_is_bounded_and_early_exit_ends_the_producer():
    ds = _Recording(400)
    loader = DataLoader(ds, 4, stack_collate, num_workers=2, prefetch=1)
    it = iter(loader)
    first = next(it)
    assert first["x"][:, 0].tolist() == [0, 1, 2, 3]
    time.sleep(0.5)  # let the producer run as far ahead as it may
    # the consumer's batch, a queued one, the one blocked in put and the
    # workers' and readahead's in flight
    bound = (1 + 1 + 1 + 2 + 1) * 4
    assert len(ds.loaded) <= bound < 400
    before = threading.active_count()
    it.close()
    deadline = time.time() + 10
    while threading.active_count() >= before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() < before


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_worker_exception_reaches_the_consumer(worker_mode):
    ds = _Recording(64, fail_at=21)
    loader = DataLoader(ds, 4, stack_collate, num_workers=2, worker_mode=worker_mode)
    seen = []
    with pytest.raises(KeyError, match="example 21 is broken"):
        for batch in loader:
            seen.append(int(batch["x"][0, 0]))
    assert seen == [0, 4, 8, 12, 16]
    # forked workers load in their own memory: the parent's record stays empty
    assert (not ds.loaded) if worker_mode == "process" else (0 in ds.loaded)


def test_device_prefetch_keeps_order_on_the_cpu(splits):
    port_ds, _ = splits["synthetic"]
    loader = DataLoader(port_ds, 8, stack_collate, shuffle=True, seed=5, num_workers=2)
    loader.set_epoch(1)
    host = list(loader)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(device_prefetch(loader, "cpu", size=2))
    spans = tracing.snapshot()["spans"]
    tracing.reset()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert sorted(g) == sorted(h)
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), h[k]), k
    # a wait on the loader for every batch and the end, a copy a batch handed over
    names = [s["name"] for s in spans]
    assert names.count("climb.data_wait") == len(host) + 1
    assert names.count("climb.h2d_copy") == len(host)
    assert all(s["parent"] is None and s["end_ns"] >= s["start_ns"] for s in spans)
    with pytest.raises(ValueError):
        DataLoader(port_ds, 8, stack_collate, worker_mode="fiber")
