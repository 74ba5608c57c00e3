"""Build the native host-pipeline libraries with g++ at first use.

The three sources beside this file (``tokenizer.cpp``, ``image_ops.cpp``,
``jpeg_decode.cpp``) compile in parallel, one ``g++`` each, with the JAX
package's flags, into ``build/climb_tpu_torch/native/`` beside the package.
Each library is named by a hash of its source, its flags and the host CPU
(``-march=native`` code must not run on another CPU), so an unchanged one is
reused. A library whose toolchain is missing (no ``g++``, no libjpeg headers
or library) is left out and the bindings leave its step to PIL or Python; a
library that fails to compile otherwise is left out too, and ``status`` says
why, so a caller can tell the two apart.

    python -m climb_tpu_torch.native.build
"""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT_BUILD_DIR = HERE.parents[1] / "build" / "climb_tpu_torch" / "native"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
# (library, source, flags after the source so that -l libraries link)
TARGETS = (
    ("tokenizer", "tokenizer.cpp", ()),
    ("image", "image_ops.cpp", ("-fopenmp",)),
    ("jpeg", "jpeg_decode.cpp", ("-ljpeg",)),
)
# compiler output that means a missing toolchain piece rather than a fault
_MISSING = ("jpeglib.h: No such file", "cannot find -ljpeg", "omp.h: No such file",
            "cannot find -lgomp")

status = {}  # library -> "built", "reused", "no toolchain: ..." or "failed: ..."


def _host_cpu() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def library_path(name: str, source: str, flags, build_dir) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + tuple(flags)).encode())
    h.update((HERE / source).read_bytes())
    h.update(_host_cpu())
    return Path(build_dir) / f"libclimb_{name}_{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> dict:
    """{library: path of the built .so, or None}; fills ``status``."""
    build_dir = Path(build_dir or DEFAULT_BUILD_DIR)
    gxx = shutil.which("g++")
    paths, procs = {}, []
    for name, source, flags in TARGETS:
        lib = library_path(name, source, flags, build_dir)
        if lib.exists():
            paths[name], status[name] = lib, "reused"
            continue
        paths[name] = None
        if gxx is None:
            status[name] = "no toolchain: g++ not found"
            continue
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *CXXFLAGS, "-o", str(tmp), str(HERE / source), *flags]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)
            paths[name], status[name] = lib, "built"
            continue
        missing = [m for m in _MISSING if m in out]
        status[name] = (f"no toolchain: {missing[0]}" if missing
                        else f"failed: {out.strip()[-2000:]}")
        try:
            os.remove(tmp)
        except OSError:
            pass
    return paths


if __name__ == "__main__":
    build()
    for name, what in status.items():
        print(f"{name}: {what}")
    sys.exit(0 if all(s in ("built", "reused") for s in status.values()) else 1)
