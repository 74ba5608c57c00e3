"""The CPU-side pieces of the bf16 tensor-core attention kernels.

The bf16 forward kernel (``climb_tpu_torch/csrc/attention.cu``) computes
``_fwd_kernel_blocked``'s online softmax over 64-key tiles, and
``attention_fwd_blocked_plain`` is that arithmetic step by step;
``chip_smoke.py`` holds the kernel to it on the card. Here it is held to the
JAX package's ``flash_attention`` forced onto ``_fa_fwd_blocked`` with
64-key blocks (interpret mode), in f32 and bf16 on numpy-seeded inputs with
ragged masks, at ragged S and on strided views of one fused QKV projection.
Also the wrappers' 16-byte layout rule (the kernels' TMA tensor maps), and
``chip_smoke.py``'s readers of the ptxas report and of cuobjdump's SASS and
what its build phase fails on, and ``chip_ab.py``'s reading of the step times.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_ab
import chip_smoke
import climb_tpu.ops.pallas_attention as pa
from climb_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from climb_tpu_torch.ops import attention

torch.set_num_threads(1)

# (atol, rtol, reason) against JAX's blocked kernel, which makes the same roundings
TOLERANCES = {
    "float32": (2e-5, 1e-4, "f32 sums in another order (tests/test_pallas_kernels.py)"),
    "bfloat16": (2e-3, 8e-3, "the same bf16 roundings of P and o after f32 sums in another "
                 "order: a 1-ulp flip of o (at most 2^-7 relative); mha_plain's roundings "
                 "(scores and the normalized P in bf16) miss it by 3.7e-3"),
}


def _inputs(s=150):
    """(2, S, 2, 64): at S = 150 two full 64-key tiles and a ragged one."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, s, 2, 64).astype(np.float32) for _ in range(3))
    mask = np.ones((2, s), np.float32)
    mask[0, 97 * s // 150:] = 0.0  # text padding (at S = 150 inside the second and third tiles)
    mask[1] = rng.rand(s) > 0.3
    mask[1, 0] = 1.0
    return q, k, v, mask


def _fused_views(q, k, v, dtype):
    """q, k, v as strided (B, S, H, D) views of one (B, S, 3 H D) tensor, as
    --fuse_qkv's projection gives them."""
    b, s, h, d = q.shape
    qkv = torch.from_numpy(np.concatenate([x.reshape(b, s, h * d) for x in (q, k, v)], -1))
    qkv = qkv.to(dtype)
    return tuple(qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))


@pytest.fixture
def blocked64(monkeypatch):
    """JAX takes ``_fa_fwd_blocked`` with 64-query and 64-key blocks."""
    monkeypatch.setattr(pa, "WHOLE_SEQ_MAX", 64)
    monkeypatch.setattr(pa, "BLOCK_Q", 64)
    monkeypatch.setattr(pa, "BLOCK_K", 64)
    calls = []
    real = pa._fa_fwd_blocked
    monkeypatch.setattr(pa, "_fa_fwd_blocked", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


# (dtype, S, q/k/v as fused views): the ragged S = 150 case keeps its old ids;
# S = 9 (one short tile) and 97 (a tile of one row past 64), and the fused views
BLOCKED_CASES = (
    [pytest.param(dtype, 150, False, id=dtype) for dtype in ("float32", "bfloat16")]
    + [pytest.param(dtype, s, fused, id=f"{dtype}-{label}")
       for dtype in ("float32", "bfloat16")
       for s, fused, label in ((9, False, "S9"), (97, False, "S97"), (150, True, "fused_qkv"))])


@pytest.mark.parametrize("dtype, s, fused", BLOCKED_CASES)
def test_blocked_plain_matches_jax_blocked_kernel(blocked64, dtype, s, fused):
    q, k, v, mask = _inputs(s)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    ref = pa.flash_attention(jq, jk, jv, jax_mask_to_bias(jnp.asarray(mask)))
    assert blocked64  # the blocked kernel ran
    if fused:
        tq, tk, tv = _fused_views(q, k, v, getattr(torch, dtype))
        assert tq.stride() == (s * 3 * 128, 3 * 128, 64, 1)
    else:
        tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = attention.attention_fwd_blocked_plain(tq, tk, tv,
                                                attention.mask_to_bias(torch.from_numpy(mask)))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol, rtol, reason = TOLERANCES[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=rtol, err_msg=reason)


def test_blocked_plain_is_attention_in_f32():
    """The online softmax computes the softmax: equal to ``mha_plain`` in f32
    at any tile size, the ragged last tile included."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs())
    bias = attention.mask_to_bias(mask)
    ref = attention.mha_plain(q, k, v, bias)
    for block_k in (64, 32, 150):
        got = attention.attention_fwd_blocked_plain(q, k, v, bias, block_k=block_k)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_blocked_plain_fully_masked_row_is_uniform():
    """Every key at -1e9: the mean of v over the S keys, as the kernel gives."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 70, 2, 64).astype(np.float32)) for _ in range(3))
    out = attention.attention_fwd_blocked_plain(q, k, v, attention.mask_to_bias(torch.zeros(1, 70)))
    np.testing.assert_allclose(out.numpy(), v.mean(1, keepdim=True).expand_as(v).numpy(),
                               atol=1e-6)


# ---- the 16-byte layout rule of the kernels' TMA tensor maps --------------------


def test_cp_async_layout_accepts_the_main_paths_layouts():
    x = torch.zeros(2, 9, 128, dtype=torch.bfloat16)
    w = torch.zeros(128, 128, dtype=torch.bfloat16)
    per_op = F.linear(x, w).view(2, 9, 2, 64)  # models/vilt_core.py's q, k, v
    fused = torch.empty(2, 9, 128, dtype=torch.bfloat16).view(2, 9, 2, 64)  # block.cu's
    heads_first = torch.empty(2, 2, 9, 64, dtype=torch.bfloat16).transpose(1, 2)
    attention.check_cp_async_layout("attention_fwd", q=per_op, k=fused, v=heads_first)


def test_cp_async_layout_rejects_misaligned_views():
    ok = torch.empty(2, 9, 2, 64, dtype=torch.bfloat16)
    shifted = torch.empty(2 * 9 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 9, 2, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match=r"attention_bwd: k must start on a 16-byte boundary"):
        attention.check_cp_async_layout("attention_bwd", q=ok, k=shifted, v=ok)
    narrow = torch.empty(2, 9, 2, 68, dtype=torch.bfloat16)[..., :64]  # H stride 136 bytes
    with pytest.raises(ValueError, match=r"attention_fwd: v must .* strides \(1224, 136, 68, 1\)"):
        attention.check_cp_async_layout("attention_fwd", q=ok, k=ok, v=narrow)


# ---- chip_smoke.py's build-phase readers ------------------------------------------

FWD = "_ZN12_GLOBAL__N_125attention_fwd_bf16_kernelEPK13__nv_bfloat16S2_S2_PKfPS0_i"
F32 = "_ZN12_GLOBAL__N_120attention_fwd_kernelEPKfS1_S1_S1_Pfixxxxxxxxxxxxxf"


def test_chip_smoke_reads_ptxas_report():
    report = (
        "== attention.cu\n"
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {FWD}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 464 bytes cmem[0]\n"
        f"ptxas info    : Compiling entry function '{F32}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {F32}\n"
        "    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 488 bytes cmem[0]\n"
    )
    assert chip_smoke.ptxas_resources(report) == {
        FWD: {"registers": 128, "spill_bytes": 0}, F32: {"registers": 255, "spill_bytes": 32}}


def test_chip_smoke_counts_hmma_per_function():
    sass = (
        "\n\tcode for sm_90a\n"
        f"\t\tFunction : {FWD}\n"
        "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90\"\n"
        "        /*0400*/                   LDSM.16.M88.4 R8, [R2] ;\n"
        "        /*0410*/                   HMMA.16816.F32.BF16 R12, R8, R4, R12 ;\n"
        "        /*0420*/                   HMMA.16816.F32.BF16 R16, R8, R6, R16 ;\n"
        f"\t\tFunction : {F32}\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n"
    )
    assert chip_smoke.sass_hmma_counts(sass) == {FWD: 2, F32: 0}


@pytest.mark.parametrize("row, fault", [
    ({"hgmma": 16, "hmma": 0, "registers": 80, "spill_bytes": 0}, None),
    ({"hgmma": 0, "hmma": 0, "registers": 80, "spill_bytes": 0}, "no HGMMA instruction"),
    ({"hgmma": 16, "hmma": 0, "registers": 80, "spill_bytes": 28}, "28 spill bytes"),
    ({"hgmma": 16, "hmma": 0, "registers": None, "spill_bytes": None},
     "not in the ptxas report"),
])
def test_chip_smoke_build_phase_faults(row, fault):
    # the attention forward, on wgmma since it left mma.sync
    assert chip_smoke.TENSOR_CORE_KERNELS["attention_fwd_bf16_kernel"] == "HGMMA"
    faults = chip_smoke.tensor_core_faults(
        [{"kernel": "attention_fwd_bf16_kernel", "instruction": "HGMMA", **row}])
    assert faults == ([] if fault is None else [f"attention_fwd_bf16_kernel: {fault}"])


# ---- chip_ab.py ----------------------------------------------------------------------


def test_chip_ab_reads_step_numbers():
    train = {"phase": "train", "n_train_steps": {"snli-ve": 8, "nlvr2": 16},
             "snli-ve": {"step_ms_events_median": 80.0, "step_ms_host_median": 130.0,
                         "train_examples_per_sec": 246.0},
             "nlvr2": {"step_ms_events_median": 81.0, "step_ms_host_median": 120.0,
                       "train_examples_per_sec": 133.0}}
    language = {"phase": "language", "step_ms_events_median": 139.0,
                "step_ms_host_median": 139.5, "train_examples_per_sec": 114.7}
    predict = {"phase": "predict", "step_ms_events_median": 13.1,
               "step_ms_host_median": 120.0, "examples_per_sec": 448.2}
    assert chip_ab.step_numbers(train) == {"train snli-ve": (80.0, 130.0, 246.0),
                                           "train nlvr2": (81.0, 120.0, 133.0)}
    assert chip_ab.step_numbers(language) == {"language": (139.0, 139.5, 114.7)}
    assert chip_ab.step_numbers(predict) == {"predict": (13.1, 120.0, 448.2)}


def test_chip_ab_reads_the_attention_forward_times():
    row = {"phase": "attention_fwd", "shape": "tp2", "q": [32, 281, 6, 64], "ms_per_call": 0.05}
    assert chip_ab.step_numbers(row) == {"attention_fwd tp2": (0.05, None, None)}
    assert "for label, b, s, h in (('serving', 64, 281, 12)," in chip_ab.CHILD


def test_chip_ab_refuses_a_tree_without_chip_smoke(tmp_path):
    with pytest.raises(SystemExit, match="2"):
        chip_ab.main([str(tmp_path), str(tmp_path)])
