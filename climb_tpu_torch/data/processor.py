"""User-facing input processor: raw (texts, images) -> model batch.

The port's copy of ``climb_tpu/data/processor.py``, over the port's
tokenizers and image pipeline; its batches equal the JAX package's byte for
byte. Parity: the reference's ``ViltEncoderWrapper.process_inputs``
(src/modeling/vilt.py:83-96, ViltProcessor called inside every forward) and
the ``convert_*_to_vilt_input_dict`` batch converters (vilt.py:548-567).
Processing is explicit and ahead of time: call it once per batch on the host;
the returned dict of numpy arrays feeds the eval step.

The converter registry resolves the string keys in
``climb_tpu_torch.configs.model_configs`` (``batch2inputs_converter``).
``build_raw_batch`` dispatches raw instance rows by their schema, for
``predict --input_jsonl`` and the HTTP server.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from climb_tpu_torch.data.image_pipeline import process_image
from climb_tpu_torch.data.tokenization import load_tokenizer


class ViltInputProcessor:
    """Tokenize + canvas-process raw inputs into the fixed-shape batch schema."""

    def __init__(
        self,
        tokenizer=None,
        max_text_len: int = 40,
        canvas_hw: Tuple[int, int] = (384, 640),
        patch_size: int = 32,
    ):
        self.tokenizer = tokenizer or load_tokenizer()
        self.max_text_len = max_text_len
        self.canvas_hw = canvas_hw
        self.patch_size = patch_size

    def process_images(self, images: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        canvases, phws = [], []
        for img in images:
            c, phw = process_image(img, self.canvas_hw, self.patch_size)
            canvases.append(c)
            phws.append(phw)
        return np.stack(canvases), np.asarray(phws, np.int32)

    def __call__(
        self,
        texts: Sequence[str],
        images: Sequence,
        text_pairs: Optional[Sequence[str]] = None,
    ) -> dict:
        """Single-image batch: texts[i] (+optional pair) with images[i].

        `images` may also be a list of [imgA, imgB] pairs (NLVR2 schema) —
        detected by list/tuple elements.
        """
        ids, mask, types = self.tokenizer.batch_encode(texts, self.max_text_len, text_pairs)
        batch = {"input_ids": ids, "text_mask": mask, "token_type_ids": types}
        if images is not None and len(images):
            if isinstance(images[0], (list, tuple)):  # image pairs
                flat, phws = [], []
                for pair in images:
                    cs, ps = self.process_images(pair)
                    flat.append(cs)
                    phws.append(ps)
                batch["pixel_values"] = np.stack(flat)
                batch["patch_hw"] = np.stack(phws)
            else:
                pv, phw = self.process_images(images)
                batch["pixel_values"] = pv
                batch["patch_hw"] = phw
        return batch

    def multi_choice(self, choice_texts: List[List[str]], images: Sequence) -> dict:
        """Multi-choice batch: choice_texts[i] = the texts for sample i."""
        encs = [
            [self.tokenizer.encode(t, self.max_text_len) for t in sample]
            for sample in choice_texts
        ]
        ids = np.stack([[e[0] for e in s] for s in encs])
        mask = np.stack([[e[1] for e in s] for s in encs])
        types = np.stack([[e[2] for e in s] for s in encs])
        batch = {"input_ids": ids, "text_mask": mask, "token_type_ids": types}
        if images is not None and len(images):
            pv, phw = self.process_images(images)
            batch["pixel_values"] = pv
            batch["patch_hw"] = phw
        return batch


# batch converters (reference vilt.py:548-567)

def convert_batch_single(processor: ViltInputProcessor, batch: dict) -> dict:
    """raw_texts + images -> model inputs (convert_batch_to_vilt_input_dict)."""
    return processor(batch["raw_texts"], batch["images"])


def convert_batch_seq(processor: ViltInputProcessor, batch, mean_image) -> dict:
    """(texts, labels) + shared mean image (convert_seq_batch_to_vilt_input_dict):
    the single processed canvas broadcasts across the batch in the model."""
    texts = list(batch[0])
    out = processor(texts, None)
    pv, phw = processor.process_images([mean_image])
    out["pixel_values"] = pv
    out["patch_hw"] = phw
    return out


def convert_batch_mc(processor: ViltInputProcessor, batch, mean_image) -> dict:
    """(texts_a, texts_b_choices, labels) + mean image
    (convert_mc_batch_to_vilt_input_dict): pair-encode text_a with each
    choice."""
    texts_a, texts_b = batch[0], batch[1]
    choice_texts = [[(a, b) for b in blist] for a, blist in zip(texts_a, texts_b)]
    encs = [
        [processor.tokenizer.encode(a, processor.max_text_len, text_pair=b) for a, b in sample]
        for sample in choice_texts
    ]
    ids = np.stack([[e[0] for e in s] for s in encs])
    mask = np.stack([[e[1] for e in s] for s in encs])
    types = np.stack([[e[2] for e in s] for s in encs])
    pv, phw = processor.process_images([mean_image])
    return {
        "input_ids": ids, "text_mask": mask, "token_type_ids": types,
        "pixel_values": pv, "patch_hw": phw,
    }


CONVERTER_REGISTRY = {
    "vilt_single": convert_batch_single,
    "vilt_seq": convert_batch_seq,
    "vilt_mc": convert_batch_mc,
}


def get_batch_converter(key: str):
    return CONVERTER_REGISTRY[key]


# raw instance rows (predict --input_jsonl and the HTTP server)

def load_raw_image(spec, where: str = "image"):
    """IMG spec -> decoded PIL image / uint8 array, with actionable errors.

    Accepts a local path string, ``{"b64": <base64 image bytes>}``, or a
    nested uint8 HWC array. Decode errors surface as ValueError (a client
    input problem), never as raw OSError/PIL exceptions.
    """
    import base64
    import io

    from PIL import Image

    try:
        if isinstance(spec, str):
            img = Image.open(spec)
            img.load()  # decode NOW so a corrupt file fails here, not later
            return img
        if isinstance(spec, dict) and "b64" in spec:
            img = Image.open(io.BytesIO(base64.b64decode(spec["b64"])))
            img.load()
            return img
        return np.asarray(spec, np.uint8)  # nested lists = raw HWC array
    except ValueError:
        raise
    except Exception as e:  # unreadable path / undecodable bytes / bad shape
        raise ValueError(f"{where}: unreadable image ({type(e).__name__}: {e})")


def build_raw_batch(processor: ViltInputProcessor, model_type: str,
                    num_images: int, rows: Sequence[dict],
                    num_choices: Optional[int] = None) -> dict:
    """Schema-dispatched batch from raw instance rows.

    Row schemas (shared by ``predict --input_jsonl`` and the HTTP server):
      {"text": str, "image": IMG}              single-image tasks
      {"text": str, "images": [IMG, IMG]}      two-image tasks (NLVR2)
      {"choices": [str, ...], "image": IMG}    multiple choice (VCR)
    """
    if not rows:
        raise ValueError("empty instance list")
    if model_type == "multi-choice":
        bad = [i for i, r in enumerate(rows) if "choices" not in r or "image" not in r]
        if bad:
            raise ValueError(f"instances {bad} missing 'choices'/'image' "
                             "(this task is multiple-choice)")
        nc = int(num_choices or len(rows[0]["choices"]))
        for i, r in enumerate(rows):
            if len(r["choices"]) != nc:
                raise ValueError(f"instance {i} has {len(r['choices'])} "
                                 f"choices; expected {nc}")
        return processor.multi_choice(
            [r["choices"] for r in rows],
            [load_raw_image(r["image"], f"instance {i} image")
             for i, r in enumerate(rows)],
        )
    if num_images == 2:
        bad = [i for i, r in enumerate(rows) if len(r.get("images", ())) != 2]
        if bad:
            raise ValueError(f"instances {bad} need 'images': [a, b] "
                             "(this task is two-image)")
        return processor(
            [r["text"] for r in rows],
            [[load_raw_image(r["images"][0], f"instance {i} images[0]"),
              load_raw_image(r["images"][1], f"instance {i} images[1]")]
             for i, r in enumerate(rows)],
        )
    bad = [i for i, r in enumerate(rows) if "text" not in r or "image" not in r]
    if bad:
        raise ValueError(f"instances {bad} missing 'text'/'image'")
    return processor(
        [r["text"] for r in rows],
        [load_raw_image(r["image"], f"instance {i} image")
         for i, r in enumerate(rows)],
    )
