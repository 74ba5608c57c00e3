"""climb_tpu_torch.cli.predict against climb_tpu.cli.predict on the CPU, and
the port's isolation from JAX.

Both CLIs serve the same synthetic split from one checkpoint that the JAX
package wrote in the reference torch layout (``save_reference_checkpoint``);
in float32 they must give identical predictions and metric.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from climb_tpu.ckpt.torch_import import save_reference_checkpoint
from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args
from climb_tpu_torch.cli.predict import main as port_predict
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TASKS = "nlvr2,snli-ve,vcr"
JAX_MODULES = ("jax", "flax", "optax", "climb_tpu")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny learner for TASKS, every leaf from numpy, saved by the JAX package."""
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=True)
    module = JaxLearner(cfg, jax_head_specs(TASKS.split(","), jax_task_configs))
    init = jax.jit(lambda key: module.init(key, dummy_batch(cfg), method=JaxLearner.init_all))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0))["params"])
    rng = np.random.RandomState(7)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tree = jax.tree_util.tree_unflatten(treedef, [
        (rng.randn(*x.shape) * 0.1 + (x == 1.0)).astype(np.float32) for x in leaves])
    path = tmp_path_factory.mktemp("ckpt") / "model"
    save_reference_checkpoint(tree, str(path), "model")
    return str(path)


def _argv(task, out_dir, checkpoint):
    return [
        "--encoder_name", "vilt", "--ordered_cl_tasks", TASKS, "--task_key", task,
        "--checkpoint", checkpoint, "--synthetic", "--tiny", "--synthetic_train_size", "48",
        "--batch_size", "8", "--compute_dtype", "float32", "--seed", "3",
        "--output_dir", str(out_dir), "--output_file", str(out_dir / f"{task}.json"),
    ]


@pytest.mark.parametrize("task", ["snli-ve", "nlvr2", "vcr"])
def test_predict_matches_jax_cli(task, checkpoint, tmp_path, monkeypatch):
    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    ref = jax_predict(_argv(task, tmp_path / "jax", checkpoint))
    out = port_predict(_argv(task, tmp_path / "port", checkpoint)
                       + ["--device", "cpu", "--attn_impl", "pallas", "--mlp_impl", "pallas"])
    assert out["n_examples"] == ref["n_examples"] == 12
    assert out["predictions"] == ref["predictions"]
    assert out["metric"] == ref["metric"]
    saved = json.loads((tmp_path / "port" / f"{task}.json").read_text())
    assert saved == out
    assert sorted(saved) == sorted(json.loads((tmp_path / "jax" / f"{task}.json").read_text()))


@pytest.mark.parametrize("flags", [
    ["--scan_unroll", "2"],  # JAX's layer-scan unroll: no effect on the port's loop
    # the profiling flags act in the trainer (tests/test_torch_tools.py); predict
    # takes them as JAX's predict does
    ["--profile_dir", "x"],
    ["--memory_profile", "x"],
    ["--do_wandb_logging"],
    ["--pretrained_model_name", "dandelin/vilt-b32-mlm"],
])
def test_unported_flags_raise(flags, tmp_path, monkeypatch, caplog):
    """The flags that raised "not ported" before the last slice now run as the
    JAX CLI runs them: the same predictions as without them. A hub name that
    is not in the local cache keeps the seed's weights with a warning (the
    checkpoint overrides them either way)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    monkeypatch.chdir(tmp_path)
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve", "--task_key", "snli-ve",
            "--synthetic", "--tiny", "--device", "cpu"]
    base = port_predict(argv + ["--output_dir", str(tmp_path / "base")])
    with caplog.at_level("WARNING"):
        out = port_predict(argv + ["--output_dir", str(tmp_path / "flags")] + flags)
    assert out["predictions"] == base["predictions"]
    assert out["n_examples"] == base["n_examples"] > 0
    if flags[0] == "--pretrained_model_name":
        assert "no local snapshot or file" in caplog.text
    assert not (tmp_path / "x").exists()


def test_predict_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve", "--task_key", "snli-ve",
            "--synthetic", "--tiny", "--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_predict(argv)  # --device defaults to cuda


IMPORT_CHECKED = ["climb_tpu_torch.cli.predict",
                  "climb_tpu_torch.cli.train_upstream_continual_learning",
                  "climb_tpu_torch.cli.train_language",
                  "climb_tpu_torch.cli.train_lowshot_multimodal",
                  "climb_tpu_torch.cli.train_vision",
                  "climb_tpu_torch.data.vision",
                  "climb_tpu_torch.data.language",
                  "climb_tpu_torch.data.loader",
                  "climb_tpu_torch.data.visionlanguage",
                  "climb_tpu_torch.data.tokenization",
                  "climb_tpu_torch.native",
                  "chip_smoke", "chip_ab",
                  "climb_tpu_torch.models.bert",
                  "climb_tpu_torch.models.viltbert",
                  "climb_tpu_torch.models.hf_import",
                  "climb_tpu_torch.train.model_factory",
                  "climb_tpu_torch.train.accum_tune",
                  "climb_tpu_torch.utils.preemption",
                  "climb_tpu_torch.ckpt.checkpoint",
                  "climb_tpu_torch.data.processor",
                  "climb_tpu_torch.ops.quant",
                  "climb_tpu_torch.serve.export",
                  "climb_tpu_torch.serve.server",
                  "climb_tpu_torch.cli.serve",
                  "climb_tpu_torch.models.hf_snapshot",
                  "climb_tpu_torch.train.profiling",
                  "climb_tpu_torch.utils.wandb",
                  "climb_tpu_torch.evaluation.make_table",
                  "climb_tpu_torch.data.host_cost",
                  "climb_tpu_torch.data.mean_image"]
# nor transformers, safetensors, msgpack or ml_dtypes: the card's machine has none
# of them (the port reads flax's msgpack checkpoints and safetensors files with its
# own decoders)
FORBIDDEN = JAX_MODULES + ("transformers", "safetensors", "msgpack", "ml_dtypes")


@pytest.fixture(scope="module")
def imported():
    """One fresh interpreter imports every module of IMPORT_CHECKED and
    reports which of them it loaded and which forbidden packages came with
    them. Imports only add modules, so if all of them together load none of
    those packages, none of them alone does."""
    code = (
        f"import importlib, json, sys; mods = {IMPORT_CHECKED!r}; "
        "[importlib.import_module(m) for m in mods]; "
        f"print(json.dumps({{'loaded': [m for m in mods if m in sys.modules], 'forbidden': "
        f"sorted({{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r})}}))"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", IMPORT_CHECKED)
def test_import_loads_no_jax(module, imported):
    """The module imports neither JAX, flax, optax, climb_tpu, transformers nor
    safetensors."""
    assert module in imported["loaded"]
    assert imported["forbidden"] == []


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_package():
    """Exact top-level names: ``climb_tpu_torch`` is not ``climb_tpu``. No
    transformers or safetensors either."""
    files = sorted((ROOT / "climb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "chip_ab.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"climb_tpu_torch/data/loader.py", "climb_tpu_torch/data/tokenization.py",
            "climb_tpu_torch/data/visionlanguage/datasets.py", "climb_tpu_torch/data/cache.py",
            "climb_tpu_torch/data/image_backbones.py", "climb_tpu_torch/native/__init__.py",
            "climb_tpu_torch/native/build.py", "climb_tpu_torch/cli/train_lowshot_multimodal.py",
            "climb_tpu_torch/cli/train_vision.py", "climb_tpu_torch/data/vision/datasets.py",
            "climb_tpu_torch/data/language/text_processors.py",
            "climb_tpu_torch/data/language/text_dataset.py", "climb_tpu_torch/models/bert.py",
            "climb_tpu_torch/models/viltbert.py", "climb_tpu_torch/models/hf_import.py",
            "climb_tpu_torch/train/accum_tune.py", "climb_tpu_torch/utils/preemption.py",
            "climb_tpu_torch/ckpt/checkpoint.py", "climb_tpu_torch/data/processor.py",
            "climb_tpu_torch/ops/quant.py", "climb_tpu_torch/serve/export.py",
            "climb_tpu_torch/serve/server.py", "climb_tpu_torch/cli/serve.py",
            "climb_tpu_torch/models/hf_snapshot.py", "climb_tpu_torch/train/profiling.py",
            "climb_tpu_torch/utils/wandb.py", "climb_tpu_torch/configs/wandb_config.py",
            "climb_tpu_torch/evaluation/make_table.py", "climb_tpu_torch/data/host_cost.py",
            "climb_tpu_torch/data/mean_image.py"} <= scanned
    bad = {(str(f.relative_to(ROOT)), root) for f in files for root in _imported_roots(f)
           if root in FORBIDDEN}
    assert not bad
