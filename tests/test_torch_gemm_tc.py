"""The bf16 GEMM of the port (``climb_tpu_torch/csrc/gemm.cuh``: wgmma fed by
TMA) around what the CPU can check: ``chip_smoke.py``'s reading of HGMMA and
HMMA per function and its build-phase faults for the GEMM kernels, the build
hash's view of the Hopper header, the wrappers' 64-multiple and 16-byte rules
(``ops.mlp.check_gemm_operands``), and ``chip_ab.py``'s reading of the serving
eval step. The kernels themselves run only on the card (``chip_smoke.py``)."""

import re
import shutil
from pathlib import Path

import pytest
import torch

import chip_ab
import chip_smoke
from climb_tpu_torch.kernels import build
from climb_tpu_torch.ops import mlp

CSRC = Path(build.__file__).resolve().parent.parent / "csrc"
GEMM = ("_ZN38_GLOBAL__N__ee709cec_6_mlp_cu_789492aa24linear_bf16_wgmma_kernelE14CUtensorMap_st"
        "S0_PK13__nv_bfloat16PS1_iiii")
ATTN = "_ZN12_GLOBAL__N_125attention_fwd_bf16_kernelEPK13__nv_bfloat16S2_S2_PKfPS0_i"
SASS = (
    "\n\tcode for sm_90a\n"
    f"\t\tFunction : {GEMM}\n"
    "        /*0300*/                   WARPGROUP.ARRIVE ;\n"
    "        /*0310*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;\n"
    "        /*0320*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"
    "        /*0330*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;\n"
    "        /*0340*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;\n"
    f"\t\tFunction : {ATTN}\n"
    "        /*0410*/                   HMMA.16816.F32.BF16 R12, R8, R4, R12 ;\n"
)


def test_sass_reader_counts_hgmma_and_hmma_apart():
    assert chip_smoke.sass_hmma_counts(SASS, "HGMMA") == {GEMM: 3, ATTN: 0}
    assert chip_smoke.sass_hmma_counts(SASS) == {GEMM: 0, ATTN: 1}


@pytest.mark.parametrize("row, fault", [
    ({"hgmma": 4, "hmma": 0, "registers": 96, "spill_bytes": 0}, None),
    ({"hgmma": 0, "hmma": 0, "registers": 96, "spill_bytes": 0}, "no HGMMA instruction"),
    ({"hgmma": 4, "hmma": 32, "registers": 96, "spill_bytes": 0},
     "32 HMMA instructions beside HGMMA"),
    ({"hgmma": 4, "hmma": 0, "registers": 120, "spill_bytes": 32}, "32 spill bytes"),
    ({"hgmma": 4, "hmma": 0, "registers": None, "spill_bytes": None}, "not in the ptxas report"),
])
def test_build_phase_faults_of_a_gemm_kernel(row, fault):
    faults = chip_smoke.tensor_core_faults(
        [{"kernel": "out_bf16_wgmma_kernel", "instruction": "HGMMA", **row}])
    assert faults == ([] if fault is None else [f"out_bf16_wgmma_kernel: {fault}"])


# the bf16 kernels, all on wgmma: the three GEMMs, the FFN backward's
# recompute, the attention forward and the two launches of the attention
# backward
WGMMA_KERNELS = {"linear_bf16_wgmma_kernel", "qkv_bf16_wgmma_kernel", "out_bf16_wgmma_kernel",
                 "mlp_bwd_bf16_wgmma_kernel", "attention_fwd_bf16_kernel",
                 "attention_bwd_dq_bf16_kernel", "attention_bwd_dkdv_bf16_kernel"}


def test_every_checked_kernel_is_in_the_sources_and_the_gemms_use_no_wmma():
    sources = {p.name: p.read_text() for p in CSRC.iterdir()}
    everything = "\n".join(sources.values())
    for kernel, instruction in chip_smoke.TENSOR_CORE_KERNELS.items():
        assert re.search(rf"\b{kernel}\(", everything), kernel
        assert instruction == "HGMMA"
    assert set(chip_smoke.TENSOR_CORE_KERNELS) == WGMMA_KERNELS
    for name in ("gemm.cuh", "mlp.cu", "mlp_bwd.cu", "block.cu"):
        assert "wmma" not in sources[name].replace("wgmma", ""), name
    # no source holds an mma.sync product, an ldmatrix or a cp.async any more
    # (tc.cuh's helpers went with the forward's last caller)
    for name, src in sources.items():
        assert not re.search(r"\b(mma_abt?|mma_bf16|load_a|ldmatrix_x4\w*|cp_async\w*)\(",
                             src), name
        assert not re.search(r"\b(mma\.sync\.aligned|ldmatrix\.sync|cp\.async\.c[ga])\b",
                             src), name
    assert set(build.HEADERS) == {n for n in sources if n.endswith(".cuh")}
    assert "hopper.cuh" in build.HEADERS


def test_build_digest_sees_the_hopper_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(build, "_CSRC", csrc)
    before = build._digest()
    assert build._digest() == before
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert build._digest() != before


def test_gemm_operands_accept_the_main_paths_widths():
    x = torch.zeros(3, 5, 128, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(256, 128, dtype=torch.bfloat16), torch.zeros(128, 256, dtype=torch.bfloat16)
    rows = x.reshape(-1, 128)[1:]  # a row offset of 256 bytes keeps the 16-byte rule
    mlp.check_gemm_operands("fused_mlp", {"D": 768, "F": 3072}, {"x": rows, "w1": w1, "w2": w2})


@pytest.mark.parametrize("width", [32, 96, 100])
def test_gemm_operands_reject_a_width_off_the_tma_box(width):
    with pytest.raises(ValueError, match=rf"fused_mlp: F={width} must be a multiple of 64"):
        mlp.check_gemm_operands("fused_mlp", {"D": 128, "F": width}, {})


def test_gemm_operands_reject_misaligned_or_strided_tensors():
    shifted = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(64, 128)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match=r"fused_attention_sublayer: wq must be contiguous and "
                                         r"start on a 16-byte boundary .*address % 16 = 2"):
        mlp.check_gemm_operands("fused_attention_sublayer", {"D": 128},
                                {"x": torch.zeros(2, 128), "wq": shifted})
    strided = torch.zeros(128, 256, dtype=torch.bfloat16)[:, :128]
    with pytest.raises(ValueError, match=r"fused_mlp: w1 must be contiguous .*contiguous False"):
        mlp.check_gemm_operands("fused_mlp", {"D": 128}, {"w1": strided})


def test_chip_ab_reads_the_serving_eval_step():
    steps = {"phase": "eval_steps", "attn_impl": "fused_block", "batch": 64,
             "step_ms_events_median": 14.5, "step_ms_events": [14.1, 14.5, 30.2]}
    assert chip_ab.step_numbers(steps) == {"eval_step fused_block": (14.5, None, None)}
