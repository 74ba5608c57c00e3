"""CL model construction (counterpart of ``climb_tpu/train/model_factory.py``).

Heads for every task in the sequence, three modality-type rows when NLVR2 is
in it, weights drawn from ``--seed`` through a ``torch.Generator``.
``--encoder_name viltbert`` builds the ViLT-BERT learner with its frozen-BERT
trainability mask (JAX ``model_factory.py:119-146``).
``--pretrained_model_name`` is read as the JAX package reads it
(``model_factory.py:248-286 _graft_pretrained``): a Hugging Face snapshot,
a directory or a hub name already in the local cache (``models.hf_snapshot``;
the port never downloads); the port also takes a checkpoint file in the
reference torch layout (a model, encoder or bare HF ``ViltModel`` state
dict; for ViLT-BERT also one holding BERT). With neither, the model keeps
its seed's initialization and a warning says so, as JAX's does when
``from_pretrained`` fails. A two-row modality table grows a third row, a copy
of the image row, when NLVR2 is in the sequence (reference vilt.py:106-108).
ViLT-BERT's BERT comes from the file when it holds BERT, else from the
``bert-base-uncased`` snapshot (JAX ``model_factory.py:270-281``), else it
stays random with a warning. Where a snapshot lacks a tensor, JAX takes the
value transformers initializes; the port keeps its own seed's.

On a mesh (``--use_mesh``, ``--n_model``, ``--fsdp``; ``--pp_stages`` builds
its own ('data', 'pipe') mesh) the learner is placed by
``parallel.sharding.shard_model`` after the pretrained weights are grafted,
with JAX's refusals (``model_factory.py:82-151``): the pipeline composes with
data parallelism only, takes no int8 dense, and needs a 'pipe' axis of its
size. int8 dense runs under ``--n_model > 1`` as in JAX (``ops/quant.py``).
"""

import dataclasses
import logging
import os

import torch

from climb_tpu_torch.ckpt.checkpoint import load_state_dict
from climb_tpu_torch.ckpt.convert import (
    load_reference_checkpoint,
    partial_load,
    with_encoder_key,
)
from climb_tpu_torch.models import hf_snapshot
from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
from climb_tpu_torch.models.surgery import expand_modality_type_embeddings
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.models.vilt_core import ViltCore, init_weights_
from climb_tpu_torch.models.viltbert import (
    ViltBertContinualLearner,
    ViltBertCore,
    viltbert_frozen_mask,
)

logger = logging.getLogger(__name__)

LEARNERS = {"vilt": ViltContinualLearner, "viltbert": ViltBertContinualLearner}
ENCODERS = {"vilt": ViltCore, "viltbert": ViltBertCore}
# the reference torch layout's encoder names (model, encoder and bare HF files)
_REFERENCE_PREFIXES = ("vilt_encoder.vilt.", "viltbert_encoder.", "vilt.embeddings.",
                       "bert.embeddings.", "embeddings.")
_NO_BERT = ("%s holds no BERT weights and no " + hf_snapshot.BERT_NAME + " snapshot resolves "
            "(the port never downloads): BERT keeps its random initialization")


def vilt_config_from_args(args, needs_three_modalities: bool) -> ViltConfig:
    kw = dict(
        modality_type_vocab_size=3 if needs_three_modalities else 2,
        dtype=getattr(args, "compute_dtype", "float32"),
        attn_impl=getattr(args, "attn_impl", "xla"),
        mlp_impl=getattr(args, "mlp_impl", "xla"),
        remat=getattr(args, "remat", False),
        remat_policy=getattr(args, "remat_policy", "full"),
        fuse_qkv=getattr(args, "fuse_qkv", False),
        scan_unroll=getattr(args, "scan_unroll", 1),
        dense_impl=getattr(args, "dense_impl", "xla"),
        pp_stages=int(getattr(args, "pp_stages", 0) or 0),
        pp_virtual=int(getattr(args, "pp_virtual", 1) or 1),
        pp_microbatches=int(getattr(args, "pp_microbatches", 0) or 0),
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


def _resolve(table: dict, encoder_name: str):
    if encoder_name not in table:
        raise ValueError(f"--encoder_name {encoder_name}: choose one of {sorted(table)}")
    return table[encoder_name]


def _with_bert(sd: dict, prefix: str, source: str) -> dict:
    """``sd`` with BERT's weights under ``prefix`` when it holds none: those of
    the ``bert-base-uncased`` snapshot, else a warning (BERT stays random)."""
    if any(k.startswith(prefix) for k in sd):
        return sd
    bert = hf_snapshot.pretrained_bert()
    if bert is None:
        logger.warning(_NO_BERT, source)
        return sd
    return {**sd, **{prefix + k: v for k, v in bert.items()}}


def load_pretrained(model: ViltContinualLearner, name: str):
    """Load ``--pretrained_model_name`` over the learner's weights: a snapshot
    (``hf_snapshot.pretrained_vilt``), else a reference-layout checkpoint file
    (a flax msgpack file raises: it is read as a task checkpoint, not as base
    weights; a ViLT file loads ViLT-BERT's ViLT side, and a ViLT-BERT file a
    ViLT learner's encoder), else a warning: the seed's weights stay."""
    enc = hf_snapshot.pretrained_vilt(name)
    if enc is not None:
        sd = with_encoder_key({"vilt." + k: v for k, v in enc.items()}, model.encoder_key)
    elif os.path.isfile(name):
        sd = with_encoder_key(load_reference_checkpoint(name), model.encoder_key)
    else:
        logger.warning("Could not load pretrained weights %s (no local snapshot or file; the "
                       "port never downloads); training from scratch", name)
        return
    mod = next(k for k in model.state_dict() if k.endswith("modality_type_embeddings.weight"))
    rows = model.cfg.modality_type_vocab_size
    if mod in sd and sd[mod].shape[0] == 2 and rows == 3:
        sd[mod] = torch.cat([sd[mod], sd[mod][1:2]], dim=0)
    if model.encoder_key == "viltbert":
        sd = _with_bert(sd, "viltbert.bert.", name)
    loaded, missing = partial_load(model, sd)
    logger.info("Pretrained %s: %d tensors loaded, %d kept from init", name, len(loaded),
                len(missing))


def pipeline_mesh(args, mesh):
    """The mesh of a ``--pp_stages > 1`` run (a new ('data', 'pipe') mesh
    when ``mesh`` is None), after JAX's checks; ``mesh`` otherwise."""
    pp_stages = int(getattr(args, "pp_stages", 0) or 0)
    if pp_stages <= 1:
        return mesh
    if getattr(args, "fsdp", False) or getattr(args, "n_model", 1) > 1:
        raise ValueError(
            "--pp_stages composes with data parallelism only; drop --fsdp/--n_model (the "
            "pipeline owns the encoder's layout)")
    if getattr(args, "dense_impl", "xla") != "xla":
        raise ValueError("--pp_stages does not support int8 dense (no calibration scales "
                         "travel through the stage schedule)")
    from climb_tpu_torch.parallel.mesh import PIPE_AXIS, make_dp_pp_mesh

    if mesh is None:
        return make_dp_pp_mesh(pp_stages)
    if PIPE_AXIS not in mesh.axis_names:
        raise ValueError(
            f"--pp_stages needs a mesh with a '{PIPE_AXIS}' axis (got {mesh.axis_names}); drop "
            f"--use_mesh — --pp_stages builds its own ('data','pipe') mesh")
    if mesh.shape[PIPE_AXIS] != pp_stages:
        raise ValueError(f"mesh '{PIPE_AXIS}' axis is {mesh.shape[PIPE_AXIS]} but "
                         f"--pp_stages={pp_stages}")
    return mesh


def create_cl_model(args, task_configs, device: torch.device, adapter_handler=None,
                    mesh=None) -> ViltContinualLearner:
    """The learner on ``device`` in eval mode (the train step switches it to
    train mode), initialized from ``args.seed``. With ``adapter_handler``
    (``cl/adapters.py``) every block holds one adapter per task, drawn with
    the rest of the weights (JAX ``model_factory.py:125-126``). ViLT-BERT's
    learner carries ``viltbert_frozen_mask`` as its trainability mask. With
    ``mesh`` (or ``--pp_stages > 1`` in a process group) the learner is
    sharded by ``parallel.sharding.shard_model``; ``model.parallel`` is None
    otherwise."""
    from climb_tpu_torch.parallel import distributed
    from climb_tpu_torch.parallel.sharding import shard_model

    if int(getattr(args, "pp_stages", 0) or 0) > 1 and (mesh is not None
                                                        or distributed.is_initialized()):
        mesh = pipeline_mesh(args, mesh)
    task_keys = list(args.ordered_cl_tasks)
    cfg = vilt_config_from_args(args, "nlvr2" in task_keys)
    learner = _resolve(LEARNERS, args.encoder_name)
    model = learner(cfg, head_specs_from_task_configs(task_keys, task_configs),
                    **(adapter_handler.model_kwargs() if adapter_handler else {}))
    generator = torch.Generator().manual_seed(int(getattr(args, "seed", 42)))
    model.reset_parameters(generator)
    pretrained = getattr(args, "pretrained_model_name", "scratch")
    if pretrained not in ("scratch", "", None):
        load_pretrained(model, pretrained)
    model = model.to(device).eval()
    if model.encoder_key == "viltbert":
        model.trainable_mask = viltbert_frozen_mask(model)
    return shard_model(model, mesh, fsdp=getattr(args, "fsdp", False),
                       pp=model.cfg.pp_stages > 1)


def _encoder_state_dict(path: str, encoder_name: str = "vilt") -> dict:
    """A checkpoint file as the state dict of the encoder ``encoder_name``
    names (``ViltCore``, or ``ViltBertCore``: ``vilt.*`` and ``bert.*``): the
    reference torch layout (an encoder or a full-model file) or the port's
    own format (a ``torch.save`` of a model's or an encoder's state dict by
    its port names) or the JAX package's msgpack file (a task ``model`` or
    ``encoder`` tree). The layouts of JAX ``model_factory.py:225-240``: a
    ViLT-BERT file gives a ViLT encoder its ViLT side, and a ViLT file gives
    ViLT-BERT's ViLT side (BERT then keeps its weights)."""
    sd = load_state_dict(path)
    if any(k.startswith(_REFERENCE_PREFIXES) for k in sd):
        sd = load_reference_checkpoint(path)
    if any(k.startswith("viltbert.") for k in sd):  # a ViLT-BERT learner or classifier
        core = {k[len("viltbert."):]: v for k, v in sd.items() if k.startswith("viltbert.")}
    elif any(k.startswith(("vilt.", "bert.")) for k in sd):  # a ViLT model, a ViltBertCore
        core = {k: v for k, v in sd.items() if k.startswith(("vilt.", "bert."))}
    else:  # a bare ViltCore
        core = {"vilt." + k: v for k, v in sd.items()}
    if encoder_name == "viltbert":
        return core
    return {k[len("vilt."):]: v for k, v in core.items() if k.startswith("vilt.")}


def load_encoder_params(checkpoint_name, cfg: ViltConfig, pretrained: str = "scratch",
                        seed: int = 0, encoder_name: str = "vilt"):
    """Encoder-only parameter loading for the Phase II drivers (counterpart of
    ``climb_tpu``'s ``load_encoder_params``; reference ``load_vilt_encoder``,
    vilt.py:481-514, and ``load_viltbert_encoder``, viltbert.py:459-493):
    start from weights drawn from ``seed`` (or pretrained weights, read as
    ``load_pretrained`` reads them; BERT's as well for 'viltbert'), with three
    modality rows when the upstream checkpoint came from a run with NLVR2
    ('nlvr2' in its path), then load the saved encoder over them. Returns
    (the state dict of a bare ``ViltCore``, or of a ``ViltBertCore`` for
    'viltbert', the cfg)."""
    core_class = _resolve(ENCODERS, encoder_name)
    needs_three = checkpoint_name is not None and "nlvr2" in str(checkpoint_name)
    if needs_three:
        cfg = dataclasses.replace(cfg, modality_type_vocab_size=3)
    core = core_class(cfg)
    init_weights_(core, torch.Generator().manual_seed(int(seed)), cfg.initializer_range)

    if pretrained not in ("scratch", "", None):
        enc = hf_snapshot.pretrained_vilt(pretrained)
        if enc is not None:
            enc = {"vilt." + k: v for k, v in enc.items()} if encoder_name == "viltbert" else enc
        elif os.path.isfile(pretrained):
            enc = _encoder_state_dict(pretrained, encoder_name)
        else:
            logger.warning("pretrained %s unavailable (no local snapshot or file; the port never "
                           "downloads); random init", pretrained)
            enc = {}
        if needs_three:
            enc, _ = expand_modality_type_embeddings(
                enc, dataclasses.replace(cfg, modality_type_vocab_size=2))
        if encoder_name == "viltbert":
            enc = _with_bert(enc, "bert.", pretrained)
        partial_load(core, enc)

    if checkpoint_name and os.path.isfile(checkpoint_name):
        loaded, missing = partial_load(core, _encoder_state_dict(checkpoint_name, encoder_name))
        logger.info("Encoder checkpoint %s: %d tensors loaded, %d from init", checkpoint_name,
                    len(loaded), len(missing))
    elif checkpoint_name not in (None, "", "scratch"):
        logger.warning("Encoder checkpoint %s not found; using base weights", checkpoint_name)
    return core.state_dict(), cfg
