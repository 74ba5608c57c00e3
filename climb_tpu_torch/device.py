"""Device selection: the card unless the caller asks for the CPU."""

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``; raises when CUDA is asked for and absent.

    There is no silent fallback to the CPU: the plain PyTorch path runs only
    when the caller passes ``cpu``.
    """
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch path on the CPU"
        )
    return device
