"""climb_tpu_torch.data.processor against climb_tpu.data.processor on the CPU.

The raw-input processor turns texts and images into the model's batch. Both
packages get the same rows (JPEG and PNG files, base64 bytes and nested
uint8 arrays, drawn from a numpy seed) and must give byte-equal batches, for
the single-image, image-pair and multiple-choice schemas, the three batch
converters, and the same errors for rows and images they refuse.
"""

import base64
import io
import re

import numpy as np
import pytest
from PIL import Image

from climb_tpu.data import processor as jax_processor
from climb_tpu.data.tokenization import HashTokenizer as JaxHashTokenizer
from climb_tpu.data.tokenization import WordPieceTokenizer as JaxWordPiece
from climb_tpu_torch.data import processor
from climb_tpu_torch.data.tokenization import HashTokenizer, WordPieceTokenizer

WORDS = ("a", "photo", "of", "two", "dogs", "cat", "on", "the", "grass", "left", "image", "is",
         "red", "blue", "man", "holding", "ball")


def _vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + list(WORDS))
                    + "\n")
    return str(path)


@pytest.fixture(params=["hash", "wordpiece"])
def processors(request, tmp_path):
    if request.param == "hash":
        tok, jtok = HashTokenizer(), JaxHashTokenizer()
    else:
        path = _vocab(tmp_path)
        tok, jtok = WordPieceTokenizer.from_vocab_file(path), JaxWordPiece.from_vocab_file(path)
    kw = dict(max_text_len=16, canvas_hw=(64, 96), patch_size=32)
    return processor.ViltInputProcessor(tok, **kw), jax_processor.ViltInputProcessor(jtok, **kw)


def _array(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _encoded(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


@pytest.fixture
def images(tmp_path):
    """Image specs of every kind the row schemas take: a JPEG path, a PNG path,
    base64 JPEG and PNG bytes, a nested uint8 array; sizes around the canvas."""
    rng = np.random.RandomState(0)
    specs = []
    for i, (h, w) in enumerate(((70, 90), (50, 120), (120, 40), (64, 96), (33, 47))):
        arr = _array(rng, h, w)
        kind = i % 5
        if kind < 2:
            path = tmp_path / f"img{i}.{'jpg' if kind == 0 else 'png'}"
            path.write_bytes(_encoded(arr, "JPEG" if kind == 0 else "PNG"))
            specs.append(str(path))
        elif kind < 4:
            blob = _encoded(arr, "JPEG" if kind == 2 else "PNG")
            specs.append({"b64": base64.b64encode(blob).decode()})
        else:
            specs.append(arr.tolist())
    return specs


def _same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert g.tobytes() == r.tobytes(), k


TEXTS = ["a photo of two dogs", "the cat is on the grass", "a man holding a red ball",
         "left image is blue", "dogs"]


def test_single_image_rows_byte_equal(processors, images):
    port, ref = processors
    rows = [{"text": t, "image": img} for t, img in zip(TEXTS, images)]
    _same(processor.build_raw_batch(port, "classification", 1, rows),
          jax_processor.build_raw_batch(ref, "classification", 1, rows))


def test_image_pair_rows_byte_equal(processors, images):
    port, ref = processors
    rows = [{"text": TEXTS[i], "images": [images[i], images[(i + 2) % 5]]} for i in range(4)]
    got = processor.build_raw_batch(port, "classification", 2, rows)
    assert got["pixel_values"].shape == (4, 2, 64, 96, 3)
    _same(got, jax_processor.build_raw_batch(ref, "classification", 2, rows))


def test_multi_choice_rows_byte_equal(processors, images):
    port, ref = processors
    rows = [{"choices": [f"{TEXTS[i]} {c}" for c in ("red", "blue", "cat", "ball")],
             "image": images[i]} for i in range(3)]
    got = processor.build_raw_batch(port, "multi-choice", 1, rows, num_choices=4)
    assert got["input_ids"].shape == (3, 4, 16)
    _same(got, jax_processor.build_raw_batch(ref, "multi-choice", 1, rows, num_choices=4))


def test_converters_byte_equal(processors, images):
    port, ref = processors
    mean = processor.load_raw_image(images[0])
    jmean = jax_processor.load_raw_image(images[0])
    assert sorted(processor.CONVERTER_REGISTRY) == sorted(jax_processor.CONVERTER_REGISTRY)
    imgs = [processor.load_raw_image(s) for s in images[:2]]
    _same(processor.get_batch_converter("vilt_single")(port, {"raw_texts": TEXTS[:2],
                                                               "images": imgs}),
          jax_processor.get_batch_converter("vilt_single")(ref, {"raw_texts": TEXTS[:2],
                                                                  "images": imgs}))
    seq = [tuple(TEXTS[:3]), np.array([0, 1, 2])]
    _same(processor.get_batch_converter("vilt_seq")(port, seq, mean),
          jax_processor.get_batch_converter("vilt_seq")(ref, seq, jmean))
    mc = [("q1", "q2"), (["a", "b", "c"], ["d", "e", "f"]), np.array([0, 2])]
    out = processor.get_batch_converter("vilt_mc")(port, mc, mean)
    assert out["input_ids"].shape == (2, 3, 16) and out["pixel_values"].shape[0] == 1
    _same(out, jax_processor.get_batch_converter("vilt_mc")(ref, mc, jmean))


BAD_IMAGES = ["/no/such/file.jpg", {"b64": "bm90IGFuIGltYWdl"}, {"b64": "!!!notbase64"},
              {"b64": ""}, [[1, 2], [3]], "relative/missing.png"]


def _no_address(err) -> str:
    return re.sub(r"0x[0-9a-f]+", "0x", str(err))


@pytest.mark.parametrize("spec", BAD_IMAGES, ids=range(len(BAD_IMAGES)))
def test_load_raw_image_errors_match(spec):
    with pytest.raises(ValueError) as ref:
        jax_processor.load_raw_image(spec, "instance 0 image")
    with pytest.raises(ValueError) as got:
        processor.load_raw_image(spec, "instance 0 image")
    # the same exception and message (PIL names its buffer by address)
    assert type(got.value) is type(ref.value)
    assert _no_address(got.value) == _no_address(ref.value)


BAD_ROWS = [
    ("classification", 1, [{"text": "no image"}]),
    ("classification", 2, [{"text": "one image", "images": ["x.jpg"]}]),
    ("multi-choice", 1, [{"choices": ["a", "b"]}]),
    ("multi-choice", 1, [{"choices": ["a", "b"], "image": [[[1, 2, 3]]]},
                         {"choices": ["a"], "image": [[[1, 2, 3]]]}]),
    ("classification", 1, []),
]


@pytest.mark.parametrize("model_type,num_images,rows", BAD_ROWS, ids=range(len(BAD_ROWS)))
def test_build_raw_batch_errors_match(processors, model_type, num_images, rows):
    port, ref = processors
    with pytest.raises(ValueError) as want:
        jax_processor.build_raw_batch(ref, model_type, num_images, rows)
    with pytest.raises(ValueError) as got:
        processor.build_raw_batch(port, model_type, num_images, rows)
    assert str(got.value) == str(want.value)
