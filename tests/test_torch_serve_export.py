"""climb_tpu_torch.serve.export on the CPU: the torch.export serving artifact.

A tiny snli-ve learner's eval step is exported and served back: the exported
programs give the eager eval step's outputs (bit for bit on the CPU, where
export keeps the ATen ops and the kernels' ops), the signature is enforced,
the batch and canvas-width ladders route and pad as in the JAX package, an
int8_static export carries its calibrated scales, the programs call the
port's kernel ops, the parameters are stored once, and a JAX artifact or a
TPU platform is refused.
"""

import io
import os
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.serve import export
from climb_tpu_torch.serve.export import ExportedModel, export_eval_step
from climb_tpu_torch.train import eval_step
from climb_tpu_torch.train.model_factory import create_cl_model

torch.set_num_threads(1)

BS = 4
META = {"task_key": "snli-ve", "patch_size": 32, "model_type": "classification",
        "num_images": 1, "num_choices": 0, "tokenizer": "synthetic", "max_text_len": 40,
        "image_height": 64, "image_width": 96, "batch_size": BS}


def _model(**kw):
    args = SimpleNamespace(tiny=True, ordered_cl_tasks=["snli-ve"], encoder_name="vilt", seed=0,
                           compute_dtype="float32", attn_impl="pallas", mlp_impl="pallas",
                           dense_impl="xla")
    for k, v in kw.items():
        setattr(args, k, v)
    return create_cl_model(args, task_configs, torch.device("cpu"))


def _batch(bs=BS, width=96, seed=0):
    rng = np.random.RandomState(seed)
    cols = rng.randint(1, width // 32 + 1, bs)
    return {"input_ids": torch.from_numpy(rng.randint(1, 100, (bs, 40)).astype(np.int32)),
            "text_mask": torch.from_numpy((np.arange(40) < rng.randint(3, 40, (bs, 1)))
                                          .astype(np.float32)),
            "pixel_values": torch.from_numpy(rng.randint(0, 256, (bs, 64, width, 3))
                                             .astype(np.uint8)),
            "patch_hw": torch.from_numpy(np.stack([rng.randint(1, 3, bs), cols], 1)
                                         .astype(np.int32)),
            "labels": torch.from_numpy(rng.randint(0, 3, bs).astype(np.int32)),
            "valid": torch.ones(bs)}


def _eager(model, batch):
    return eval_step.make_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype)(batch)


def _export(model, path, **kw):
    return export_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype, _batch(), str(path),
                            META, platforms=("cpu",), **kw)


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """A 2 x 2 artifact: batch sizes (2, 4) x canvas widths (64, 96)."""
    model = _model()
    path = tmp_path_factory.mktemp("ladder") / "snli-ve.pt2"
    meta = _export(model, path, batch_sizes=[2], canvas_widths=[64])
    return model, str(path), meta


@pytest.mark.parametrize("kw", [dict(), dict(attn_impl="fused_block"),
                                dict(dense_impl="int8", mlp_impl="xla")],
                         ids=["pallas", "fused_block", "int8"])
def test_roundtrip_equals_eager(kw, tmp_path):
    model = _model(**kw)
    _export(model, tmp_path / "a.pt2")
    served = ExportedModel(str(tmp_path / "a.pt2"), "cpu")
    batch = _batch(seed=1)
    for got, ref in zip(served(batch), _eager(model, batch)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.equal(got, ref)  # expected bit-equal on the CPU


def test_ladder_routes_and_pads(ladder):
    model, path, meta = ladder
    served = ExportedModel(path, "cpu")
    assert meta["batch_sizes"] == [2, 4] and meta["canvas_widths"] == [64, 96]
    assert served.batch_sizes == (2, 4) and served.canvas_widths == (64, 96)
    assert [served.pick_batch_size(n) for n in (1, 2, 3, 4, 9)] == [2, 2, 4, 4, 4]
    assert [served.pick_canvas_width(w) for w in (32, 64, 65, 96, 200)] == [64, 64, 96, 96, 96]
    assert export.pick_from_ladder((1, 8), 5) == 8
    full = _batch(bs=2, seed=2)
    full["patch_hw"][:, 1] = torch.tensor([2, 1], dtype=torch.int32)  # fits 64 columns
    narrow = dict(full, pixel_values=full["pixel_values"][:, :, :64].contiguous())
    ref = _eager(model, full)
    got = served(narrow)  # the (2, 64) program
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[1], ref[1])
    # a 32-wide canvas pads up to the 64 program, losslessly
    slim = dict(full, pixel_values=full["pixel_values"][:, :, :32].contiguous(),
                patch_hw=torch.tensor([[2, 1], [1, 1]], dtype=torch.int32))
    fitted = served.fit_batch(slim)
    assert fitted["pixel_values"].shape[2] == 64
    assert torch.equal(fitted["pixel_values"][:, :, :32], slim["pixel_values"])
    assert not fitted["pixel_values"][:, :, 32:].any()
    np_fitted = served.fit_batch({k: v.numpy() for k, v in slim.items()})
    np.testing.assert_array_equal(np_fitted["pixel_values"], fitted["pixel_values"].numpy())
    ref_slim = _eager(model, dict(slim, pixel_values=fitted["pixel_values"]))
    np.testing.assert_allclose(served(fitted)[0].numpy(), ref_slim[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    served.warmup()


def test_signature_validation(ladder):
    _, path, _ = ladder
    served = ExportedModel(path, "cpu")
    batch = _batch()
    with pytest.raises(ValueError, match=r"missing from batch: \['labels'\]"):
        served({k: v for k, v in batch.items() if k != "labels"})
    with pytest.raises(ValueError, match=r"batch size\(s\) \[3\] not in the artifact's program "
                                         r"ladder \[2, 4\]"):
        served({k: v[:3] for k, v in batch.items()})
    with pytest.raises(ValueError, match=r"batch\['input_ids'\] is int64\[4, 40\], but the "
                                         r"artifact was exported for int32\[4, 40\]"):
        served(dict(batch, input_ids=batch["input_ids"].long()))
    with pytest.raises(ValueError, match=r"batch\['pixel_values'\] is uint8\[4, 64, 80, 3\]"):
        served(dict(batch, pixel_values=batch["pixel_values"][:, :, :80]))
    with pytest.raises(ValueError, match="Full signature: input_ids: int32"):
        served(dict(batch, text_mask=batch["text_mask"][:, :20]))
    extra = dict(batch, image_id=torch.zeros(4))  # extra keys are dropped
    assert list(served.validate_batch(extra)) == list(served.batch_spec)
    numpy_batch = {k: v.numpy() for k, v in batch.items()}  # numpy arrays are served too
    assert torch.equal(served(numpy_batch)[0], served(batch)[0])


def test_export_argument_errors(tmp_path):
    model = _model()
    with pytest.raises(ValueError, match="must lie in 1..4"):
        _export(model, tmp_path / "x.pt2", batch_sizes=[8])
    with pytest.raises(ValueError, match=r"canvas widths \[48\] invalid"):
        _export(model, tmp_path / "x.pt2", canvas_widths=[48])
    with pytest.raises(ValueError, match="tpu"):
        export_eval_step(model, "snli-ve", "ce", torch.float32, _batch(), str(tmp_path / "x"),
                         META, platforms=("tpu", "cpu"))
    with pytest.raises(ValueError, match="tpu"):
        export.parse_platforms("cuda,tpu")
    assert export.parse_platforms("cuda,cpu,cuda") == ("cuda", "cpu")
    assert not (tmp_path / "x.pt2").exists()


def test_int8_static_scales_baked_in(tmp_path):
    model = _model(dense_impl="int8_static", mlp_impl="xla")
    scales = eval_step.calibrate_quant_scales(model, "snli-ve", [_batch(seed=s) for s in (3, 4)])
    assert len(scales) == 6 * model.cfg.num_layers + 1
    _export(model, tmp_path / "q.pt2")
    payload = export.load_artifact(str(tmp_path / "q.pt2"))
    for name, value in scales.items():
        assert torch.equal(payload["params"][name], value)
    batch = _batch(seed=5)
    ref = _eager(model, batch)
    served = ExportedModel(str(tmp_path / "q.pt2"), "cpu")
    assert torch.equal(served(batch)[0], ref[0])
    dynamic = _model(dense_impl="int8", mlp_impl="xla")
    assert not torch.equal(_eager(dynamic, batch)[0], ref[0])  # the static scales served


def test_programs_call_the_kernel_ops_and_hold_no_weights(ladder):
    _, path, _ = ladder
    payload = export.load_artifact(path)
    assert sorted(payload["programs"]) == ["cpu:2:64", "cpu:2:96", "cpu:4:64", "cpu:4:96"]
    ep = torch.export.load(io.BytesIO(zlib.decompress(payload["programs"]["cpu:4:96"])))
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {"climb_tpu_torch.normalize_u8.default", "climb_tpu_torch.attention_fwd.default",
            "climb_tpu_torch.fused_mlp.default"} <= targets
    assert not ep.state_dict and ep.example_inputs is None


def test_served_program_drops_only_the_metadata_asserts(ladder):
    _, path, _ = ladder
    payload = export.load_artifact(path)
    ep = torch.export.load(io.BytesIO(zlib.decompress(payload["programs"]["cpu:4:96"])))
    stock, served = ep.module(), export.serving_module(ep)

    def targets(program):
        return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]

    asserts = [t for t in targets(stock) if "_assert_tensor_metadata" in t]
    assert asserts and not [t for t in targets(served) if "_assert_tensor_metadata" in t]
    assert [t for t in targets(stock) if "_assert_tensor_metadata" not in t] == targets(served)
    params = {k: v for k, v in payload["params"].items()}
    batch = ExportedModel(path, "cpu").validate_batch(_batch(seed=6))
    with torch.no_grad():
        for got, ref in zip(served.forward(params, batch), stock(params, batch)):
            assert torch.equal(got, ref)


def test_four_variant_artifact_stores_parameters_once(ladder):
    model, path, _ = ladder
    param_bytes = sum(t.numel() * t.element_size() for t in export.model_state(model).values())
    size = os.path.getsize(path)
    assert param_bytes < size < 1.2 * param_bytes, (size, param_bytes)


def test_jax_artifact_is_refused(tmp_path):
    from flax import serialization

    path = tmp_path / "snli-ve.climbx"  # the JAX package's payload layout, no program
    path.write_bytes(serialization.msgpack_serialize(
        {"stablehlo": b"\x00", "params": {}, "meta": {"format_version": 1}}))
    with pytest.raises(ValueError, match="JAX .*msgpack/StableHLO artifact"):
        ExportedModel(str(path), "cpu")
    other = tmp_path / "notes.txt"
    other.write_text("hello")
    with pytest.raises(ValueError, match="not an artifact"):
        ExportedModel(str(other), "cpu")


def test_devices(ladder, monkeypatch):
    _, path, _ = ladder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ExportedModel(path)  # the card by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"no program for cuda; the artifact was exported for "
                                         r"\['cpu'\]"):
        ExportedModel(path, "cuda")
