"""Serving artifacts: a trained eval step as one file of ``torch.export`` programs.

Counterpart of ``climb_tpu/serve/export.py``. The eval step (``prepare_batch``
with the uint8 normalize kernel, the forward, ``batch_metric``) is exported
with ``torch.export`` for a fixed batch signature, as a function of
(parameters, batch), and written with the parameters, buffers and int8_static
scales and a meta dict into a single file. Serving then needs this file, torch
and the port's kernel library (its dispatcher ops), not the model code or a
checkpoint.

- One program per (platform, batch size, canvas width): ``platforms`` names
  ``cuda`` and/or ``cpu`` (constants such as ``torch.ones(..., device=)`` are
  baked per device, so each platform has its own programs); the batch-size and
  canvas-width ladders are exported as their cross product.
- The parameters are stored once: the model is not a submodule of the
  exported module and reaches its weights through ``functional_call``, so no
  program holds a copy of them (nor its example inputs, which are dropped);
  each program is stored zlib-compressed.
- The input signature travels in the meta dict and is validated per call with
  the expected signature spelled out.

Differences from the JAX package's artifact, by design: the file is the
port's own format (a ``torch.save`` archive of ``torch.export`` programs), not
JAX's msgpack of StableHLO, so neither package reads the other's; ``tpu`` is
not a platform here; and loading an artifact registers the port's kernel ops
(``climb_tpu_torch.ops``), which the programs call.

Produced by ``climb_tpu_torch.cli.predict --export_model PATH`` and consumed by
``predict --from_export PATH``, the HTTP server or :class:`ExportedModel`.
"""

import io
import logging
import os
import zlib
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.train.eval_step import eval_forward

logger = logging.getLogger(__name__)

FORMAT = "climb_tpu_torch.export"
FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
# The canvas-width axis of 'pixel_values': (..., H, W, C) for both single-
# image (B, H, W, C) and image-pair (B, 2, H, W, C) layouts.
WIDTH_AXIS = -2
_ZIP_MAGIC = b"PK\x03\x04"


def pick_from_ladder(ladder: Sequence[int], n: int) -> int:
    """Smallest ladder size holding ``n`` (the largest when ``n`` exceeds every
    size: callers split). Shared by ExportedModel and the HTTP batcher."""
    for size in ladder:
        if n <= size:
            return size
    return ladder[-1]


def dtype_name(x) -> str:
    """numpy's name of a tensor's or array's dtype ('int32', 'uint8', ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def parse_platforms(spec) -> tuple:
    """``--export_platforms``: a comma list (or sequence) of 'cuda' and 'cpu'."""
    names = [p for p in (spec.split(",") if isinstance(spec, str) else spec) if p]
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(f"export platforms {bad or names}: this port exports for "
                         f"{list(PLATFORMS)} (a TPU program is the JAX package's artifact)")
    return tuple(dict.fromkeys(names))


class _EvalProgram(torch.nn.Module):
    """``eval_forward`` as a function of (params, batch). The model is held in
    a tuple, so it is not a submodule and the program lifts none of its
    weights: they arrive as the ``params`` input."""

    def __init__(self, model, task_key, loss_type, compute_dtype):
        super().__init__()
        self._step = (model, task_key, loss_type, compute_dtype)

    def forward(self, params: dict, batch: dict):
        model, task_key, loss_type, compute_dtype = self._step
        return eval_forward(model, task_key, loss_type, compute_dtype, batch, params)


def model_state(model: torch.nn.Module) -> dict:
    """Parameters and buffers (the int8_static scales among them) by name."""
    return {**{n: p.detach() for n, p in model.named_parameters()},
            **{n: b.detach() for n, b in model.named_buffers()}}


def _variant_batch(host_batch: dict, bs: int, width: Optional[int], device) -> dict:
    """A zero batch of one (batch size, canvas width) program variant."""
    out = {}
    for k, v in host_batch.items():
        shape = [bs] + list(v.shape[1:])
        if k == "pixel_values" and width is not None:
            shape[WIDTH_AXIS] = width
        out[k] = torch.zeros(shape, dtype=v.dtype, device=device)
    return out


def export_eval_step(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                     compute_dtype, batch: dict, path: str, meta: dict,
                     platforms: Sequence[str] = PLATFORMS,
                     batch_sizes: Optional[Sequence[int]] = None,
                     canvas_widths: Optional[Sequence[int]] = None) -> dict:
    """Export ``model``'s eval step for ``batch``'s signature and write the
    single-file artifact to ``path``. ``meta`` carries what a server needs to
    rebuild the inputs without the model (canvas, text length, head spec,
    tokenizer). Returns the stored meta dict, with the signature added.

    The two program ladders (exported as their cross product): ``batch_sizes``,
    one program per size (each at most the signature batch), so a server pads
    a coalesced batch only to the smallest program that holds it; and
    ``canvas_widths``, one program per pixel-canvas width (patch-size
    multiples up to the signature width), the serving form of aspect
    bucketing: the cropped columns are masked padding, so results are equal.
    """
    platforms = parse_platforms(platforms)
    host_batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                  .detach().cpu() for k, v in batch.items()}
    sig_bs = int(next(iter(host_batch.values())).shape[0])
    sizes = sorted({int(b) for b in (batch_sizes or ())} | {sig_bs})
    if sizes[-1] > sig_bs or sizes[0] < 1:
        raise ValueError(f"ladder batch sizes {sizes} must lie in 1..{sig_bs}, the signature "
                         f"batch")
    if canvas_widths and "pixel_values" not in host_batch:
        raise ValueError("canvas_widths ladder needs a 'pixel_values' input")
    sig_w = (int(host_batch["pixel_values"].shape[WIDTH_AXIS])
             if "pixel_values" in host_batch else None)
    widths = (sorted({int(w) for w in (canvas_widths or ())} | {sig_w})
              if sig_w is not None else [None])
    if sig_w is not None:
        patch = int(meta.get("patch_size", 0) or 0)
        bad = [w for w in widths if w > sig_w or w <= 0 or (patch and w % patch)]
        if bad:
            raise ValueError(f"canvas widths {bad} invalid: each must be a positive patch-size "
                             f"({patch}) multiple <= the signature width {sig_w}")
    model.eval()
    state = model_state(model)
    program = _EvalProgram(model, task_key, loss_type, compute_dtype)
    programs = {}
    for platform in platforms:
        device = resolve_device(platform)
        params = {k: v.to(device) for k, v in state.items()}
        for bs in sizes:
            for w in widths:
                with torch.no_grad():
                    ep = torch.export.export(
                        program, (params, _variant_batch(host_batch, bs, w, device)),
                        strict=False)
                ep.example_inputs = None  # they hold a copy of every parameter
                buf = io.BytesIO()
                torch.export.save(ep, buf)
                programs[f"{platform}:{bs}:{'' if w is None else w}"] = zlib.compress(
                    buf.getvalue())
        del params
    meta = dict(meta)
    meta.update(format_version=FORMAT_VERSION, torch_version=str(torch.__version__),
                platforms=list(platforms), batch_sizes=sizes,
                batch_spec={k: [list(v.shape), dtype_name(v)] for k, v in host_batch.items()})
    if sig_w is not None:
        meta["canvas_widths"] = widths
    payload = {"format": FORMAT, "meta": meta, "programs": programs,
               "params": {k: v.cpu() for k, v in state.items()}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logger.info("Exported %s eval step (%d tensors, platforms=%s, %d programs, %d bytes) -> %s",
                meta.get("task_key"), len(state), ",".join(platforms), len(programs),
                os.path.getsize(path), path)
    return meta


def load_artifact(path: str) -> dict:
    """The artifact's payload; ValueError for a JAX artifact or another file."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != _ZIP_MAGIC:
        what = ("a JAX (climb_tpu) msgpack/StableHLO artifact" if head[:1] and
                (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)) else "not an artifact")
        raise ValueError(f"{path}: {what}; climb_tpu_torch serves only its own torch.export "
                         f"artifacts (re-export with climb_tpu_torch.cli.predict --export_model)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a climb_tpu_torch serving artifact")
    version = int(payload["meta"].get("format_version", -1))
    if version != FORMAT_VERSION:
        raise ValueError(f"{path}: artifact format_version {version} != supported "
                         f"{FORMAT_VERSION} (re-export with this climb_tpu_torch)")
    return payload


def serving_module(ep) -> torch.nn.Module:
    """``ep.module()`` without the graph's metadata asserts: ``torch.export``
    records one ``aten._assert_tensor_metadata`` a ``.to()`` call, a third of
    the eval step's graph, each a host call that launches nothing.
    The dtypes and devices they hold are fixed by the signature that
    ``ExportedModel`` checks and by the stored parameters."""
    program = ep.module()
    target = getattr(torch.ops.aten, "_assert_tensor_metadata", None)
    if target is not None:
        graph = program.graph
        for node in list(graph.nodes):
            if node.op == "call_function" and node.target is target.default:
                graph.erase_node(node)
        program.recompile()
    return program


class ExportedModel:
    """Serve an :func:`export_eval_step` artifact on ``device``.

    ``__call__(batch)`` runs the program of the batch's (batch size, canvas
    width) with the stored parameters and returns ``(logits, metric_sum,
    metric_count)``. The batch must match the exported signature; key, shape
    and dtype mismatches raise ``ValueError`` with the signature spelled out.
    Runs on the card unless ``device`` is 'cpu'; without a card 'cuda' raises.
    """

    def __init__(self, path: str, device="cuda"):
        # the programs call the kernels' dispatcher ops: register them
        from climb_tpu_torch.ops import attention, block, image_ops, mlp  # noqa: F401

        self.device = resolve_device(str(device))
        payload = load_artifact(path)
        self.meta = payload["meta"]
        platform = self.device.type
        self._programs = {}
        for key, blob in payload["programs"].items():
            plat, bs, w = key.split(":")
            if plat == platform:
                ep = torch.export.load(io.BytesIO(zlib.decompress(blob)))
                self._programs[(int(bs), int(w) if w else None)] = serving_module(ep)
        if not self._programs:
            raise ValueError(f"{path}: no program for {platform}; the artifact was exported "
                             f"for {self.meta['platforms']}")
        self.params = {k: v.to(self.device) for k, v in payload["params"].items()}
        self.batch_spec = {k: (tuple(shape), dtype)
                           for k, (shape, dtype) in self.meta["batch_spec"].items()}
        self.batch_sizes = tuple(sorted({bs for bs, _ in self._programs}))
        self.canvas_widths = tuple(sorted({w for _, w in self._programs if w is not None})) \
            or None

    @property
    def platforms(self):
        return tuple(self.meta["platforms"])

    def pick_batch_size(self, n: int) -> int:
        """Smallest ladder program that holds ``n`` examples."""
        return pick_from_ladder(self.batch_sizes, n)

    def pick_canvas_width(self, needed_w: int) -> Optional[int]:
        """Smallest width-ladder program whose canvas holds ``needed_w``
        valid pixel columns (the widest when nothing fits; None without a
        ladder)."""
        if self.canvas_widths is None:
            return None
        return pick_from_ladder(self.canvas_widths, needed_w)

    def _signature_str(self) -> str:
        return ", ".join(f"{k}: {dtype}{list(shape)}"
                         for k, (shape, dtype) in sorted(self.batch_spec.items()))

    def validate_batch(self, batch: dict) -> dict:
        """Check keys, shapes and dtypes against the signature; returns the
        signature's keys in its order (extra keys are dropped). The leading
        axis may be any ladder batch size, the canvas width any ladder
        width."""
        missing = sorted(set(self.batch_spec) - set(batch))
        if missing:
            raise ValueError(f"exported model input(s) missing from batch: {missing}; "
                             f"expected signature: {self._signature_str()}")
        got_bs = {tuple(batch[k].shape)[:1] for k in self.batch_spec}
        if len(got_bs) != 1 or next(iter(got_bs))[0] not in self.batch_sizes:
            raise ValueError(f"batch size(s) {sorted(b[0] for b in got_bs)} not in the "
                             f"artifact's program ladder {list(self.batch_sizes)} (fixed-shape "
                             f"serving; pad to a ladder size or re-export)")
        out = {}
        for k, (shape, dtype) in self.batch_spec.items():
            v = batch[k]
            got_shape = tuple(v.shape)
            want_trailing, got_trailing = list(shape[1:]), list(got_shape[1:])
            if k == "pixel_values" and self.canvas_widths is not None:
                if got_trailing and got_trailing[WIDTH_AXIS] in self.canvas_widths:
                    want_trailing[WIDTH_AXIS] = got_trailing[WIDTH_AXIS]
            if got_trailing != want_trailing or dtype_name(v) != dtype:
                raise ValueError(
                    f"batch['{k}'] is {dtype_name(v)}{list(got_shape)}, but the artifact was "
                    f"exported for {dtype}{list(shape)} (fixed-shape serving; re-export for "
                    f"other shapes; canvas-width ladder: {self.canvas_widths}). Full "
                    f"signature: {self._signature_str()}")
            out[k] = v
        return out

    def fit_batch(self, batch: dict) -> dict:
        """Pad the pixel canvas up to the nearest width-ladder program: the
        added zero columns are masked padding, so this is lossless."""
        if self.canvas_widths is None or "pixel_values" not in batch:
            return batch
        pv = batch["pixel_values"]
        w = int(pv.shape[WIDTH_AXIS])
        target = pick_from_ladder(self.canvas_widths, w)
        if target == w:
            return batch
        batch = dict(batch)
        if isinstance(pv, torch.Tensor):
            batch["pixel_values"] = torch.nn.functional.pad(pv, (0, 0, 0, target - w))
        else:
            pad = [(0, 0)] * np.ndim(pv)
            pad[WIDTH_AXIS] = (0, target - w)
            batch["pixel_values"] = np.pad(pv, pad)
        return batch

    def warmup(self) -> None:
        """One zero batch through every program, so that no request pays a
        first call's set-up."""
        for bs, w in sorted(self._programs, key=lambda key: (key[0], key[1] or 0)):
            batch = {}
            for k, (shape, dtype) in self.batch_spec.items():
                shp = [bs] + list(shape)[1:]
                if k == "pixel_values" and w is not None:
                    shp[WIDTH_AXIS] = w
                batch[k] = torch.zeros(shp, dtype=getattr(torch, dtype), device=self.device)
            self(batch)

    def __call__(self, batch: dict):
        batch = self.validate_batch(batch)
        batch = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
                 .to(self.device) for k, v in batch.items()}
        bs = next(iter(batch.values())).shape[0]
        w = (batch["pixel_values"].shape[WIDTH_AXIS]
             if "pixel_values" in batch and self.canvas_widths is not None else None)
        program = self._programs.get((bs, w))
        if program is None:
            raise ValueError(f"no exported program for (batch={bs}, width={w}); available: "
                             f"{sorted(self._programs, key=lambda k: (k[0], k[1] or 0))}")
        # forward, not __call__: the module's pre-hook would check every input
        # (the parameters too) against the program's, which validate_batch did
        with torch.no_grad():
            return program.forward(self.params, batch)


def make_predict_meta(model, args, spec, loss_type: str) -> dict:
    """What ``predict --from_export`` and the server need to rebuild the input
    pipeline without the model: canvas and tokenizer config, the head spec."""
    cfg = model.cfg
    return {
        "task_key": spec.task_key,
        "loss_type": loss_type,
        "model_type": spec.model_type,
        "num_labels": int(spec.num_labels),
        "num_images": int(spec.num_images),
        "num_choices": int(spec.num_choices or 0),
        "batch_size": int(args.batch_size),
        "hidden_size": int(cfg.hidden_size),
        "max_text_len": int(cfg.max_text_len),
        "image_height": int(cfg.image_height),
        "image_width": int(cfg.image_width),
        "patch_size": int(cfg.patch_size),
        "compute_dtype": str(cfg.dtype),
        "encoder_name": str(getattr(args, "encoder_name", "vilt")),
        "dense_impl": str(getattr(args, "dense_impl", "xla") or "xla"),
        "tokenizer": str(getattr(args, "tokenizer", "bert-base-uncased")),
    }


def predict_shim(meta):
    """A model-shaped stand-in for predict's raw-row batches when serving
    ``--from_export``: the fields they read (the canvas, the text length, the
    task's head spec)."""
    from climb_tpu_torch.models.model_config import HeadSpec

    spec = HeadSpec(task_key=meta["task_key"], model_type=meta["model_type"],
                    num_labels=int(meta["num_labels"]), num_images=int(meta["num_images"]),
                    num_choices=int(meta["num_choices"]) or None)
    cfg = SimpleNamespace(max_text_len=int(meta["max_text_len"]),
                          image_height=int(meta["image_height"]),
                          image_width=int(meta["image_width"]), patch_size=int(meta["patch_size"]))
    return SimpleNamespace(cfg=cfg, head_specs=(spec,))
