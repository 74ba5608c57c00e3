"""The vision-only task datasets of Phase II (ImageNet, Places365, iNat2019,
COCO-cls) on their on-disk layouts."""

from climb_tpu_torch.data.vision.datasets import (
    CocoClsDataset,
    ImageNetDataset,
    Inat2019Dataset,
    Places365Dataset,
    build_vision_dataset,
)

__all__ = [
    "ImageNetDataset",
    "Places365Dataset",
    "Inat2019Dataset",
    "CocoClsDataset",
    "build_vision_dataset",
]
