"""On-device image normalization: uint8 canvas -> float in [-1, 1].

Counterpart of ``climb_tpu/ops/image_ops.py`` (the plain expression) and
``climb_tpu/ops/pallas_image.py`` (the TPU kernel). ``normalize_images``
calls the dispatcher op ``climb_tpu_torch::normalize_u8``, which launches
``csrc/normalize.cu`` for a CUDA tensor and runs the plain version for a CPU
tensor; both equal the JAX package's ``normalize_images`` bit for
bit in float32 and bfloat16.
"""

import torch

from climb_tpu_torch.kernels import LAUNCHES, define_op
from climb_tpu_torch.kernels import build

# ViltImageProcessor defaults: image_mean = image_std = [0.5, 0.5, 0.5].
VILT_MEAN = 0.5
VILT_STD = 0.5


def normalize_images_plain(pixels_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, C) in [0, 255] -> normalized float in [-1, 1].

    The constant 1/255 is rounded to ``dtype`` first, as JAX rounds its
    weakly typed Python scalar; in bfloat16 a float32 constant would change
    111 of the 256 results.
    """
    inv255 = torch.tensor(1.0 / 255.0, dtype=dtype, device=pixels_u8.device)
    x = pixels_u8.to(dtype) * inv255
    return (x - VILT_MEAN) / VILT_STD


def _normalize_cuda(pixels_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``csrc/normalize.cu`` on a CUDA tensor: checks, launch, count."""
    if pixels_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_images: expected uint8, got {pixels_u8.dtype}")
    if dtype not in build.DTYPES:
        raise TypeError(f"normalize_images: output dtype {dtype} not in {list(build.DTYPES)}")
    if not pixels_u8.is_contiguous() or pixels_u8.data_ptr() % 16:
        raise ValueError("normalize_images: input must be contiguous and 16-byte aligned")
    out = torch.empty(pixels_u8.shape, dtype=dtype, device=pixels_u8.device)
    lib = build.load_library()
    build.check(
        lib.climb_normalize_u8(
            pixels_u8.data_ptr(), out.data_ptr(), pixels_u8.numel(), build.DTYPES[dtype],
            build.stream_handle(pixels_u8.device),
        ),
        "normalize_u8",
    )
    LAUNCHES["normalize_u8"] += 1
    return out


normalize_u8 = define_op(
    "normalize_u8(Tensor pixels, ScalarType dtype) -> Tensor",
    normalize_images_plain, _normalize_cuda,
    lambda pixels, dtype: pixels.new_empty(pixels.shape, dtype=dtype))


def normalize_images(pixels_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Any-shape uint8 canvas -> ``dtype`` through the op ``normalize_u8``: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if pixels_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"normalize_images: unsupported device {pixels_u8.device}")
    return normalize_u8(pixels_u8, dtype)
