"""Patch embedding as reshape + matmul (counterpart of ``climb_tpu/ops/patch_embed.py``)."""

import torch


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H//p)*(W//p), p*p*C), patches in row-major grid order.

    Per-patch feature order is (patch_row, patch_col, channel), the flatten
    order of the patch projection's input features.
    """
    b, h, w, c = pixel_values.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = pixel_values.reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, p, p, C)
    return x.reshape(b, gh * gw, p * p * c)


def patch_grid_mask(patch_hw: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(B, 2) valid (rows, cols) -> (B, grid_h*grid_w) float mask, 1 inside the
    sample's top-left anchored valid region."""
    dev = patch_hw.device
    rows = torch.arange(grid_h, device=dev)[None, :, None] < patch_hw[:, 0][:, None, None]
    cols = torch.arange(grid_w, device=dev)[None, None, :] < patch_hw[:, 1][:, None, None]
    return (rows & cols).reshape(patch_hw.shape[0], grid_h * grid_w).to(torch.float32)
