"""Build the CUDA kernels under ``climb_tpu_torch/csrc`` and bind them with ctypes.

The sources have a plain C interface, so each one compiles with ``nvcc`` in
seconds; all of them compile in parallel (one ``nvcc`` per source, started
together) and link into one shared library under ``build/climb_tpu_torch/``
beside the package. The library is named by a hash of the sources and flags,
so a changed source builds anew and an unchanged one is reused, with the
ptxas report (registers and spills per kernel) of the build that made it.

Nothing here runs at import time: the first kernel launch calls
``load_library()``. Without ``nvcc`` it raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("attention.cu", "attention_bwd.cu", "block.cu", "mlp.cu", "mlp_bwd.cu",
           "normalize.cu")
HEADERS = ("common.cuh", "gemm.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "climb_tpu_torch"

# the dtypes the kernels take, by their codes in csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_LL3 = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "climb_normalize_u8": (_P, _P, _LL, _I, _P),
    "climb_attention_fwd": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL3, _LL3, _LL3, _LL3, _LL,
        ctypes.c_float, _I, _P,
    ),
    "climb_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _LL3, _LL3, _LL3, _LL3, _LL3, _LL3, _LL3, _LL, ctypes.c_float, _I, _P,
    ),
    "climb_linear_bias_act": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "climb_mlp_bwd_recompute": (_P,) * 7 + (_I,) * 3 + (_P,),
    "climb_fused_attention_sublayer": (_P,) * 18 + (_I,) * 5 + (ctypes.c_float, _I, _P),
}

_library = None
last_build = {}  # seconds and ptxas report of the build this process made or reused


def find_nvcc():
    """Path of nvcc on PATH or under CUDA_HOME / /usr/local/cuda, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir=DEFAULT_BUILD_DIR, nvcc=None) -> Path:
    """Compile every source in parallel and link them; returns the .so path."""
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: the "
            "climb_tpu_torch CUDA kernels are built from climb_tpu_torch/csrc "
            "with nvcc for sm_90a on the machine that has the card"
        )
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"libclimb_kernels_{_digest()}.so"
    report = lib.with_suffix(".ptxas.txt")
    if lib.exists() and report.exists():
        last_build.update(seconds=0.0, reused=True, ptxas=report.read_text())
        return lib
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = build_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        reports.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(reports))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    ptxas = "\n".join(reports)
    report.write_text(ptxas)
    os.replace(tmp, lib)
    last_build.update(seconds=time.perf_counter() - t0, reused=False, ptxas=ptxas)
    return lib


def load_library():
    """The bound kernel library, built at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(status: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    tensor's device, which carries its index), for a C entry to launch on;
    without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` returns (some 5 us a call on the host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_LL3_ARRAY = ctypes.c_longlong * 3


def strides3(t):
    """(B, S, H) element strides of a (B, S, H, D) tensor as a C array."""
    st = t.stride()
    return _LL3_ARRAY(st[0], st[1], st[2])
