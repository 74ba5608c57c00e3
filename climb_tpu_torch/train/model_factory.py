"""CL model construction (counterpart of ``climb_tpu/train/model_factory.py``).

Heads for every task in the sequence, three modality-type rows when NLVR2 is
in it, weights drawn from ``--seed`` through a ``torch.Generator``. Pretrained
HF weights are not ported: the port serves checkpoints, which override them.
"""

import logging

import torch

from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner

logger = logging.getLogger(__name__)


def vilt_config_from_args(args, needs_three_modalities: bool) -> ViltConfig:
    kw = dict(
        modality_type_vocab_size=3 if needs_three_modalities else 2,
        dtype=getattr(args, "compute_dtype", "float32"),
        attn_impl=getattr(args, "attn_impl", "xla"),
        mlp_impl=getattr(args, "mlp_impl", "xla"),
    )
    if getattr(args, "tiny", False):
        kw.update(
            vocab_size=2048, hidden_size=64, num_layers=getattr(args, "num_layers", 2),
            num_heads=4, intermediate_size=128, image_height=64, image_width=96,
            patch_size=32, pretrain_image_size=64,
        )
    else:
        kw.update(
            image_height=getattr(args, "image_height", 384),
            image_width=getattr(args, "image_width", 640),
        )
    return ViltConfig(**kw)


def create_cl_model(args, task_configs, device: torch.device) -> ViltContinualLearner:
    """The learner on ``device`` in eval mode, initialized from ``args.seed``."""
    task_keys = list(args.ordered_cl_tasks)
    cfg = vilt_config_from_args(args, "nlvr2" in task_keys)
    if args.encoder_name != "vilt":
        raise NotImplementedError(
            f"--encoder_name {args.encoder_name}: only 'vilt' is ported (ViLT-BERT "
            "comes with a later slice)")
    model = ViltContinualLearner(cfg, head_specs_from_task_configs(task_keys, task_configs))
    generator = torch.Generator().manual_seed(int(getattr(args, "seed", 42)))
    model.reset_parameters(generator)
    pretrained = getattr(args, "pretrained_model_name", "scratch")
    if pretrained not in ("scratch", "", None):
        logger.warning("pretrained weights %s are not ported; random init (a "
                       "--checkpoint overrides every weight)", pretrained)
    return model.to(device).eval()
