"""The port's VQAv2, NLVR2, SNLI-VE and VCR datasets against the JAX
package's on the mini CLiMB data root of ``tests/test_driver_real_data.py``:
every example bit for bit (ids, masks, canvases, patch dims, labels, soft
targets), the parse caches (the same files, read across packages, and never a
class of the JAX package), ``convert_to_low_shot`` under a seed,
``canvas_widths`` and ``text_lengths``. All comparisons are exact.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.data.visionlanguage import build_vl_datasets as jax_build
from climb_tpu.utils.seed import set_seed as jax_set_seed
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.cache import load_pickle_cache
from climb_tpu_torch.data.visionlanguage import build_vl_datasets
from test_driver_real_data import climb_dir  # noqa: F401  (the mini data root)
from test_torch_data_common import copy_root, jax_native_route  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TASKS = ("vqa", "nlvr2", "snli-ve", "vcr")
CACHES = {"vqa": "vqav2/cached_vqa_data", "nlvr2": "nlvr2/cached_nlvr2_data",
          "snli-ve": "snli-ve/cached_ve_data", "vcr": "vcr/cached_vcr_data"}


def args_for(root, visual_input_type="pil-image"):
    return SimpleNamespace(climb_data_dir=root, image_height=64, image_width=96, max_text_len=16,
                           tokenizer="bert-base-uncased",
                           vocab_path=os.path.join(root, "vocab.txt"),
                           visual_input_type=visual_input_type)


@pytest.fixture(scope="module")
def roots(climb_dir, tmp_path_factory, jax_native_route):  # noqa: F811
    """One copy of the mini root per package, each parsed by that package."""
    base = tmp_path_factory.mktemp("roots")
    out = {"jax": copy_root(climb_dir, base / "jax"), "port": copy_root(climb_dir, base / "port")}
    out["datasets"] = {
        task: (jax_build(args_for(out["jax"]), task, jax_task_configs[task]),
               build_vl_datasets(args_for(out["port"]), task, task_configs[task]))
        for task in TASKS}
    return out


def rooted(obj, root):
    """``obj`` with the data root's path replaced in every string (NLVR2's and
    VCR's records hold absolute image paths)."""
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    if isinstance(obj, dict):
        return {rooted(k, root): rooted(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(rooted(v, root) for v in obj)
    return obj


def assert_examples_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) > 0
    assert rooted(got_ds.data, got_ds.data_dir.rsplit("/", 1)[0]) == \
        rooted(want_ds.data, want_ds.data_dir.rsplit("/", 1)[0])
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = np.asarray(got[k])
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (i, k)
            assert np.array_equal(g, w), (i, k)


@pytest.mark.parametrize("task", TASKS)
def test_examples_bit_equal(roots, task):
    for want, got in zip(*roots["datasets"][task]):
        assert type(got).__name__ == type(want).__name__
        assert_examples_equal(got, want)
    # the same parse caches (the same builtin lists and dicts; byte for byte
    # where they hold no path of the root)
    jax_dir, port_dir = (Path(roots[p]) / CACHES[task] for p in ("jax", "port"))
    names = sorted(os.listdir(jax_dir))
    assert names and names == sorted(os.listdir(port_dir))
    for name in names:
        with open(jax_dir / name, "rb") as f:
            want = pickle.load(f)
        assert rooted(load_pickle_cache(str(port_dir / name)), roots["port"]) == \
            rooted(want, roots["jax"]), name
        if task in ("vqa", "snli-ve"):
            assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes(), name


@pytest.mark.parametrize("task", TASKS)
def test_hints_and_low_shot_match_jax(roots, task):
    train_jax, train_port = roots["datasets"][task][0][0], roots["datasets"][task][1][0]
    assert np.array_equal(train_port.canvas_widths(), train_jax.canvas_widths())
    assert np.array_equal(train_port.text_lengths(), train_jax.text_lengths())
    low_shot = ({"percentage": 0.5} if task in ("vqa", "vcr") else {"num_shots_per_class": 1})
    for seed in (0, 7):
        got = build_vl_datasets(args_for(roots["port"]), task, task_configs[task])[0]
        want = jax_build(args_for(roots["jax"]), task, jax_task_configs[task])[0]
        got.convert_to_low_shot(seed=seed, **low_shot)
        want.convert_to_low_shot(seed=seed, **low_shot)
        assert_examples_equal(got, want)


def test_raw_visual_input_is_host_normalized_pil_image(roots):
    pil = roots["datasets"]["nlvr2"][1][1]
    raw = build_vl_datasets(args_for(roots["port"], "raw"), "nlvr2", task_configs["nlvr2"])[1]
    jax_raw = jax_build(args_for(roots["jax"], "raw"), "nlvr2", jax_task_configs["nlvr2"])[1]
    from climb_tpu_torch.data.image_pipeline import normalize_canvas_host

    for i in range(len(pil)):
        r, p = raw[i]["pixel_values"], pil[i]["pixel_values"]
        assert r.dtype == np.float32 and np.array_equal(r, normalize_canvas_host(p))
        assert np.array_equal(r.view(np.int32), jax_raw[i]["pixel_values"].view(np.int32))


def test_port_reads_jax_caches_without_importing_jax(roots, tmp_path):
    """Datasets over the root the JAX package parsed load its caches (the
    annotation files are gone, so nothing can be re-parsed) in a process that
    never imports climb_tpu; a cache holding a class of the JAX package is
    refused without importing it."""
    root = Path(roots["jax"])
    for path in (root / "snli-ve" / "snli_ve_train.jsonl", root / "nlvr2" / "data" / "dev.json"):
        os.rename(path, str(path) + ".gone")
    want = {task: [ds.data for ds in roots["datasets"][task][0]] for task in ("snli-ve", "nlvr2")}
    (tmp_path / "want.json").write_text(json.dumps(want))
    poisoned = tmp_path / "poisoned.pkl"
    poisoned.write_bytes(pickle.dumps([jax_set_seed]))
    code = f"""
import json, pickle, sys
from types import SimpleNamespace
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.cache import load_pickle_cache
from climb_tpu_torch.data.visionlanguage import build_vl_datasets
args = SimpleNamespace(climb_data_dir={str(root)!r}, image_height=64, image_width=96,
                       max_text_len=16, tokenizer="x", vocab_path={str(root / 'vocab.txt')!r},
                       visual_input_type="pil-image")
want = json.load(open({str(tmp_path / 'want.json')!r}))
for task in ("snli-ve", "nlvr2"):
    got = [ds.data for ds in build_vl_datasets(args, task, task_configs[task])]
    assert json.loads(json.dumps(got)) == want[task], task
try:
    load_pickle_cache({str(poisoned)!r})
    raise SystemExit("the poisoned cache loaded")
except pickle.UnpicklingError as e:
    assert "JAX package" in str(e)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("climb_tpu", "jax", "flax")))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
    with open(poisoned, "rb") as f:  # the same bytes do name the JAX function
        assert pickle.load(f) == [jax_set_seed]
    assert load_pickle_cache(str(tmp_path / "absent.pkl")) is None


def test_text_memo_survives_concurrent_workers():
    """The tokenizer memo is shared by the loader's thread workers; evicting its
    oldest entry must not race (without the lock this raised KeyError and
    'dictionary changed size during iteration', and overfilled the memo).
    More threads than cores and a short switch interval, bounded in time."""
    from concurrent.futures import ThreadPoolExecutor

    from climb_tpu_torch.data.visionlanguage.datasets import VLDatasetBase

    class Echo:
        def encode(self, text, max_len):
            return text

    ds = VLDatasetBase(Echo(), 16, (64, 96))
    ds.TOK_CACHE_MAX = 4
    errors = []

    def work(i):
        try:
            for j in range(1500):
                assert ds.encode_text(f"text {i} {j}") == f"text {i} {j}"
        except Exception as e:  # collected: an executor would hold it in its future
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 8)) as pool:
            list(pool.map(work, range(4 * (os.cpu_count() or 8))))
    finally:
        sys.setswitchinterval(interval)
    assert errors == [] and len(ds._tok_cache) <= ds.TOK_CACHE_MAX
