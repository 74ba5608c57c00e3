"""The vision-language task datasets (VQAv2, NLVR2, SNLI-VE, VCR) on a CLiMB
data root."""

from climb_tpu_torch.data.visionlanguage.datasets import (
    NLVR2Dataset,
    SnliVEDataset,
    VCRDataset,
    VQADataset,
    build_vl_datasets,
)

__all__ = [
    "VQADataset",
    "NLVR2Dataset",
    "SnliVEDataset",
    "VCRDataset",
    "build_vl_datasets",
]
