"""int8 dense layers under tensor parallelism against climb_tpu on the CPU.

The JAX package runs ``--dense_impl int8|int8_static`` on a ('data',
'model') mesh through GSPMD, which takes a row-split product's scales as a
max over 'model' and sums its int32 partial products exactly, so its mesh
gives its single device's logits. The reference here is therefore JAX's
single-device int8 forward of the tiny learner (one numpy-seeded tree,
through ``state_dict_from_jax``), on a numpy-seeded batch with uint8 pixels.
The port runs in a spawned 2-rank gloo world (``tests/torch_parallel_worker.py``)
at TP 2, and alone on each rank for its one-rank logits.

Tolerances:
- TP against the port's one rank, ``mlp_impl`` xla (every dense per op),
  int8 and int8_static with the same scales: bit-equal in float32 and
  bfloat16. The column-split products see whole rows, the row-split ones
  quantize with the group's scales and rescale the exact int32 sum, and
  attention is per head. Each side's own int8_static calibration differs
  from the other's (below), so those logits are held at the dtype's
  tolerance of the next item.
- TP against one rank, ``mlp_impl`` pallas (the FFN kernel keeps the FFN in
  the compute dtype, as in JAX, and its partial outputs are summed in
  float32): float32 at tests/test_torch_port_model.py's ``ATOL``/``RTOL``
  (summation order); bfloat16 at ``BF16_ATOL``/``BF16_RTOL``: each partial
  is rounded to bf16 before the sum and the sum once more, where one rank
  rounds once, and later layers carry that difference.
- TP against JAX: float32 at ``ATOL``/``RTOL``, with JAX's calibrated scales
  for int8_static and the tie rule of tests/test_torch_serve_quant.py (a
  miss confined to one example must vanish when every scale moves by 1e-4
  of itself); bfloat16: the same argmax, as that file holds one rank.
- LoRA deltas on the int8 products (``LORA_CASE``): see
  ``test_tp_lora_deltas_on_int8_products``.
- Calibration: the port's scales equal on both ranks, bit for bit, and
  JAX's single-device calibration at ``SCALE_RTOL`` in float32 (the sums of
  LayerNorm and of the split products run in another order) and
  ``SCALE_RTOL_BF16`` in bfloat16 (a recorded abs-max is a bf16 value, and
  the float forward's bf16 roundings upstream move it by up to two of
  them).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.cli.predict import build_parser as jax_predict_parser
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltConfig as JaxViltConfig
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.train_step import calibrate_quant_scales as jax_calibrate
from climb_tpu.train.train_step import make_eval_step as jax_eval_step
from climb_tpu_torch.ckpt.convert import quant_from_jax, state_dict_from_jax
from climb_tpu_torch.cli import predict
from climb_tpu_torch.train import model_factory
from tests import torch_parallel_worker as worker
from tests.test_torch_port_model import TINY, _randomize

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4  # tests/test_torch_port_model.py
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
SCALE_RTOL, SCALE_RTOL_BF16 = 1e-6, 2.0 ** -6
LORA_TIE_ATOL = 1e-3
NUDGE = np.float32(1 + 1e-4)
TASK, TASKS = "snli-ve", ("nlvr2", "snli-ve", "vcr")
CASES = [dict(dense_impl=d, mlp_impl=m, dtype=t) for d in ("int8", "int8_static")
         for m in ("xla", "pallas") for t in ("float32", "bfloat16")]
IDS = ["-".join(c.values()) for c in CASES]
# LoRA on a column-split and both row-split projections, whose int8 output is
# whole on every rank while their deltas are partial sums
LORA_CASE = dict(dense_impl="int8", mlp_impl="xla", dtype="float32", lora=("q", "attn_out", "fc2"))
DUMMY = {"input_ids": jnp.zeros((2, 40), jnp.int32), "text_mask": jnp.ones((2, 40), jnp.float32),
         "pixel_values": jnp.zeros((2, 64, 96, 3), jnp.float32),
         "patch_hw": jnp.ones((2, 2), jnp.int32)}


def _batch(seed, rows=8):
    """An snli-ve batch: ragged text, uint8 pixels, ragged patch grids."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, 41, rows)
    return {"input_ids": rng.randint(1, 100, (rows, 40)).astype(np.int32),
            "text_mask": (np.arange(40) < lengths[:, None]).astype(np.float32),
            "token_type_ids": np.zeros((rows, 40), np.int32),
            "pixel_values": rng.randint(0, 256, (rows, 64, 96, 3)).astype(np.uint8),
            "patch_hw": np.stack([rng.randint(1, 3, rows), rng.randint(1, 4, rows)],
                                 1).astype(np.int32),
            "labels": rng.randint(0, 3, rows).astype(np.int32)}


def _jax_module(case):
    return JaxLearner(JaxViltConfig(**TINY, **case), jax_head_specs(TASKS, jax_task_configs))


def _key(case):
    """JAX's calibration of a case: per FFN route (the FFN kernel's layers
    record none) and dtype."""
    return case["mlp_impl"], case["dtype"]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's single-device logits and calibrations for every case, and the
    port's world (started first, so that it runs while JAX computes)."""
    params = jax.jit(lambda key: _jax_module(CASES[0]).init(key, DUMMY,
                                                            method=JaxLearner.init_all))(
        jax.random.PRNGKey(0))["params"]
    tree = _randomize(jax.tree_util.tree_map(np.asarray, params), seed=1)
    batch, calibration = _batch(0), [_batch(1), _batch(2)]
    qcols, scales = {}, {}
    for case in CASES:
        if case["dense_impl"] == "int8_static":
            key = _key(case)
            qcols[key] = jax_calibrate(_jax_module(case), TASK, _jax(tree),
                                       [_jax(b) for b in calibration], jnp.dtype(case["dtype"]))
            nudged = jax.tree_util.tree_map(lambda x: x * NUDGE, qcols[key])
            scales[key] = [quant_from_jax(jax.tree_util.tree_map(np.asarray, q))
                           for q in (qcols[key], nudged)]
    payload = dict(config=TINY, tasks=TASKS, task=TASK, cases=CASES + [LORA_CASE], batch=batch,
                   calibration=calibration, scales=scales,
                   state_dict=state_dict_from_jax(tree))
    world = worker.World("int8_eval", 2, str(tmp_path_factory.mktemp("int8_eval")), payload,
                         timeout=240)
    def jax_logits(case, nudge=False):
        """JAX's single-device float32 logits of ``case`` (int8_static with
        its calibrated scales, nudged by ``NUDGE`` when asked)."""
        extra = None
        if case["dense_impl"] == "int8_static":
            qcol = qcols[_key(case)]
            extra = {"quant": jax.tree_util.tree_map(lambda x: x * NUDGE, qcol)
                     if nudge else qcol}
        logits = jax_eval_step(_jax_module(case), TASK, "ce", jnp.dtype(case["dtype"]),
                               extra_vars=extra)(_jax(tree), _jax(batch))[0]
        return np.asarray(logits.astype(jnp.float32))

    refs = [jax_logits(case) for case in CASES]
    return world.result(), (refs, jax_logits), {k: v[0] for k, v in scales.items()}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_logits_match_one_rank(runs, case):
    got = runs[0][CASES.index(case)]
    exact = case["mlp_impl"] == "xla"
    pairs = [(got["tp"], got["one"], exact and case["dense_impl"] == "int8")]
    if case["dense_impl"] == "int8_static":  # the same scales on both sides
        pairs += [(tp, one, exact) for tp, one in zip(got["tp_given"], got["one_given"])]
    for tp, one, bit_equal in pairs:
        assert tp.shape == one.shape == (8, 3) and torch.isfinite(tp).all()
        if bit_equal:
            assert torch.equal(tp, one)
        elif case["dtype"] == "float32":
            np.testing.assert_allclose(tp.numpy(), one.numpy(), atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_allclose(tp.numpy(), one.numpy(), atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_logits_match_jax(runs, case):
    """The TP logits against JAX's single device; int8_static with JAX's
    calibrated scales carried across (then nudged, for a rounding tie)."""
    got, (refs, jax_logits) = runs[0][CASES.index(case)], runs[1]
    outs = [got["tp"]] if case["dense_impl"] == "int8" else got["tp_given"]
    out, ref = outs[0].numpy(), refs[CASES.index(case)]
    if case["dtype"] == "bfloat16":
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
        return
    missed = ~np.isclose(out, ref, atol=ATOL, rtol=RTOL)
    if missed.any() and case["dense_impl"] == "int8_static":
        assert missed.any(-1).sum() == 1, np.abs(out - ref).max(-1)
        out, ref = outs[1].numpy(), jax_logits(case, nudge=True)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", [c for c in CASES if c["dense_impl"] == "int8_static"],
                         ids=[i for c, i in zip(CASES, IDS) if c["dense_impl"] == "int8_static"])
def test_tp_calibration_matches_jax(runs, case):
    """The calibrated ``<name>_amax`` buffers: equal on both ranks, and JAX's
    single-device calibration under JAX's names. (The patch projection's is
    max |pixel|; JAX's jitted calibration normalizes the uint8 pixels in
    another rounding, 1.0000001 for 255, where both packages' own
    normalization gives 1.0.)"""
    got, ref = runs[0][CASES.index(case)], runs[2][_key(case)]
    first, second = got["tp_rank_scales"]
    assert sorted(first) == sorted(second) == sorted(ref) == sorted(got["one_scales"])
    assert len(ref) == (6 if case["mlp_impl"] == "xla" else 4) * TINY["num_layers"] + 1
    for name in ref:
        assert torch.equal(first[name], second[name]), name
        assert float(first[name]) > 0, name
    rtol = SCALE_RTOL if case["dtype"] == "float32" else SCALE_RTOL_BF16
    for name in ref:
        np.testing.assert_allclose(float(first[name]), float(ref[name]), rtol=rtol, err_msg=name)


def _predict_argv(out, dense_impl, *extra):
    return ["--device", "cpu", "--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2",
            "--task_key", "snli-ve", "--synthetic", "--tiny", "--synthetic_train_size", "24",
            "--batch_size", "8", "--seed", "3", "--dense_impl", dense_impl,
            "--quant_calibration_batches", "2", "--output_dir", str(out),
            "--output_file", str(out / "preds.json"), *extra]


@pytest.mark.parametrize("dense_impl", ["int8", "int8_static"])
def test_predict_on_the_mesh_matches_one_process(dense_impl, tmp_path):
    """``predict --use_mesh --n_model 2`` in a 2-rank world writes the
    one-process run's output JSON (its throughput aside)."""
    argv = _predict_argv(tmp_path / "mesh", dense_impl, "--use_mesh", "--n_model", "2")
    world = worker.World("predict", 2, str(tmp_path / "world"), dict(argv=argv), timeout=240)
    one = predict.main(_predict_argv(tmp_path / "one", dense_impl))
    mesh = world.result()
    for out in (one, mesh):
        out.pop("examples_per_sec")
    assert mesh == one
    assert one["n_examples"] > 0 and len(one["predictions"]) == one["n_examples"]


def test_phase1_eval_on_the_mesh_runs_int8(tmp_path):
    """The Phase I driver under TP 2 with --dense_impl int8 trains in float and
    evaluates with the int8 products on the mesh; its results equal the
    one-process run's (the same predictions: the float train steps differ by
    summation order only)."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver

    def argv(out, *extra):
        return ["--device", "cpu", "--encoder_name", "vilt", "--pretrained_model_name",
                "scratch", "--climb_data_dir", str(out), "--synthetic", "--tiny",
                "--synthetic_train_size", "16", "--batch_size", "8", "--seed", "3",
                "--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft",
                "--dense_impl", "int8", "--output_dir", str(out), "--do_train", "--do_eval",
                *extra]

    world = worker.World("driver", 2, str(tmp_path / "world"),
                         dict(argv=argv(tmp_path / "mesh", "--use_mesh", "--n_model", "2")),
                         timeout=240)
    driver.main(argv(tmp_path / "one"))
    world.result()
    results = [json.loads(next((tmp_path / run).glob("*/results.json")).read_text())
               for run in ("mesh", "one")]
    assert results[0] == results[1] and len(results[0]) == 1


@pytest.mark.parametrize("dense_impl", ["int8", "int8_static"])
def test_int8_under_the_pipeline_raises_as_in_jax(dense_impl, tmp_path):
    """--pp_stages still refuses int8 dense, in both packages, before a mesh is
    built (the port's pipeline mesh is checked where one would be built)."""
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve", "--task_key", "snli-ve",
            "--tiny", "--output_dir", str(tmp_path), "--pp_stages", "2", "--dense_impl",
            dense_impl]
    args, jax_args = predict.build_parser().parse_args(argv), jax_predict_parser().parse_args(argv)
    jax_args.ordered_cl_tasks = jax_args.ordered_cl_tasks.split(",")
    with pytest.raises(ValueError, match="does not support int8 dense"):
        model_factory.pipeline_mesh(args, None)
    with pytest.raises(ValueError, match="does not support int8 dense"):
        jax_create_cl_model(jax_args, jax_task_configs)


def test_tp_lora_deltas_on_int8_products(runs):
    """LoRA deltas on int8 products under TP (an adapter run served with
    --dense_impl int8): the delta on a row-split product (attn_out, fc2) is
    summed over 'model' after the whole int8 output. Its float32 sum runs in
    another order than one rank's, which can move a later layer's dynamic
    int8 code across a rounding tie; so the logits agree with one rank's at
    ``ATOL``/``RTOL`` in every example but at most one, and within
    ``LORA_TIE_ATOL`` (one code of one activation) in that one. The deltas
    themselves move the logits by far more."""
    got = runs[0][len(CASES)]
    plain = runs[0][CASES.index({k: v for k, v in LORA_CASE.items() if k != "lora"})]
    tp, one = got["tp"].numpy(), got["one"].numpy()
    assert np.isfinite(tp).all()
    assert (~np.isclose(tp, one, atol=ATOL, rtol=RTOL)).any(-1).sum() <= 1
    np.testing.assert_allclose(tp, one, atol=LORA_TIE_ATOL, rtol=0)
    assert np.abs(one - plain["one"].numpy()).max() > 100 * LORA_TIE_ATOL
