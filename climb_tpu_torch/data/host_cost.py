"""Host input-pipeline cost model: can the host feed the card's step?
(The port's copy of ``climb_tpu/data/host_cost.py``, on the port's ``native``,
``image_pipeline`` and ``collation``.)

Each host op is timed per example, alone, with the implementations the
loader runs:

- ``process_jpeg_file``: C++ libjpeg decode and C++ bicubic resample into the
  canvas (``process_image``, PIL, where the native libraries did not build);
- tokenize: the WordPiece ``load_tokenizer`` gives for a ~28k-entry vocab;
- collate: the memcpy of fixed-shape rows into a batch (``stack_collate``),
  priced as its byte count over the host's memory bandwidth, which
  ``measure_host_costs`` measures on the host it runs on.

Cost model: the loader's workers are threads and each op above releases the
interpreter lock in C++ (``--worker_mode thread``), so W workers sustain
about ``W / per_example_seconds`` examples a second. The JAX package prices
the collate at an assumed 5 GB/s of a TPU-VM host; here it is priced at the
bandwidth measured on the host that runs the model, by default, and the
headline to feed is an H100 reading that the caller passes (``--headline``,
e.g. ``chip_smoke.py`` phase train's examples/s, with the card's name beside
it): no TPU number is a default.

Usage: python -m climb_tpu_torch.data.host_cost --headline EX_PER_S [--workers N] [--out F]
"""

import io
import json
import os
import tempfile
import time
from typing import Optional, Tuple

import numpy as np


def make_test_jpeg(h: int = 375, w: int = 500, quality: int = 85) -> bytes:
    """A natural-image-like JPEG at the typical COCO source size (smooth
    gradients and mild texture; white noise would decode unrepresentatively
    slowly)."""
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(yy / 37.0) + 40 * np.cos(xx / 23.0)
    tex = np.random.RandomState(0).randn(h, w) * 8
    ch0 = np.clip(base + tex, 0, 255).astype(np.uint8)
    rgb = np.stack([ch0, np.roll(ch0, 7, axis=0), np.roll(ch0, 13, axis=1)], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def make_wordpiece_vocab(path: str, n_words: int = 28000) -> str:
    """A WordPiece vocab of realistic size (the lookup cost grows with it):
    the specials and synthetic word / ##suffix entries."""
    rng = np.random.RandomState(0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    entries = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen = set(entries)
    while len(entries) < n_words:
        n = rng.randint(2, 10)
        word = "".join(letters[i] for i in rng.randint(0, 26, n))
        if rng.rand() < 0.3:
            word = "##" + word
        if word not in seen:
            seen.add(word)
            entries.append(word)
    with open(path, "w") as f:
        f.write("\n".join(entries))
    return path


def _best_rate(fn, n_per_call: int, iters: int = 5) -> float:
    """Best-of-``iters`` seconds per item of ``fn()``, which does ``n_per_call``."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best / n_per_call


def measure_memory_bandwidth(nbytes: int = 64 << 20, iters: int = 3) -> float:
    """This host's large-copy bandwidth (bytes/s), which prices the collate."""
    src = np.ones(nbytes, np.uint8)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return nbytes / best


def measure_host_costs(
    canvas_hw: Tuple[int, int] = (384, 640),
    text_len: int = 40,
    batch: int = 64,
    iters: int = 5,
    tmpdir: Optional[str] = None,
    bw_nbytes: int = 64 << 20,
) -> dict:
    """Per-example seconds of every host-path op, alone, with the loader's
    implementations; the dict ``cost_model`` takes."""
    from climb_tpu_torch.data.collation import stack_collate
    from climb_tpu_torch.data.image_pipeline import process_image, process_jpeg_file
    from climb_tpu_torch.data.tokenization import load_tokenizer
    from climb_tpu_torch.native import native_available

    with tempfile.TemporaryDirectory(prefix="host_cost_", dir=tmpdir) as work:
        out = {"native": native_available(), "canvas_hw": list(canvas_hw),
               "text_len": text_len, "batch": batch}

        # 1. JPEG -> canvas
        jpg_path = os.path.join(work, "cost.jpg")
        with open(jpg_path, "wb") as f:
            f.write(make_test_jpeg())
        if process_jpeg_file(jpg_path, canvas_hw) is not None:
            out["jpeg_to_canvas_s"] = _best_rate(
                lambda: [process_jpeg_file(jpg_path, canvas_hw) for _ in range(8)], 8, iters)
            out["jpeg_to_canvas_impl"] = "native"
        else:
            from PIL import Image

            def pil_canvas():
                # opened anew each call: a reused Image keeps its decoded raster
                with Image.open(jpg_path) as img:
                    return process_image(img, canvas_hw)

            out["jpeg_to_canvas_s"] = _best_rate(
                lambda: [pil_canvas() for _ in range(8)], 8, iters)
            out["jpeg_to_canvas_impl"] = "pil-fallback"

        # 2. tokenize
        tok = load_tokenizer(make_wordpiece_vocab(os.path.join(work, "vocab.txt")))
        texts = ["a person riding a horse on the beach near the blue water today"] * 64
        out["tokenize_s"] = _best_rate(
            lambda: [tok.encode(t, text_len) for t in texts], len(texts), iters)
        out["tokenize_impl"] = type(tok).__name__

    # 3. collate: the wall clock here, and the byte count for the bandwidth model
    ch, cw = canvas_hw
    example = {
        "pixel_values": np.zeros((ch, cw, 3), np.uint8),
        "input_ids": np.zeros((text_len,), np.int32),
        "text_mask": np.ones((text_len,), np.float32),
        "patch_hw": np.array([12, 20], np.int32),
        "labels": np.zeros((), np.int32),
    }
    examples = [dict(example) for _ in range(batch)]
    out["collate_s_raw"] = _best_rate(lambda: stack_collate(examples), batch, iters)
    out["bytes_per_example"] = int(sum(np.asarray(v).nbytes for v in example.values()))
    out["host_bw_bytes_per_s"] = measure_memory_bandwidth(bw_nbytes)
    return out


def cost_model(measured: dict, headline_ex_s: float, workers: int,
               host_bw_bytes_per_s: Optional[float] = None) -> dict:
    """Does a host with ``workers`` loader threads sustain ``headline_ex_s``?

    The compute-bound ops (decode and resample, tokenize) take their measured
    time; the memcpy-bound collate is priced as bytes over
    ``host_bw_bytes_per_s``, by default the bandwidth ``measured`` holds.
    """
    if host_bw_bytes_per_s is None:
        host_bw_bytes_per_s = measured["host_bw_bytes_per_s"]
    collate_s = measured["bytes_per_example"] / host_bw_bytes_per_s
    per_example_s = measured["jpeg_to_canvas_s"] + measured["tokenize_s"] + collate_s
    sustained = workers / per_example_s
    return {
        "per_example_ms": {
            "jpeg_to_canvas": round(measured["jpeg_to_canvas_s"] * 1e3, 4),
            "tokenize": round(measured["tokenize_s"] * 1e3, 4),
            "collate_at_bw": round(collate_s * 1e3, 4),
            "total": round(per_example_s * 1e3, 4),
        },
        "host_bw_assumed_gb_s": host_bw_bytes_per_s / 1e9,
        "workers": workers,
        "sustained_ex_s": round(sustained, 1),
        "headline_ex_s": headline_ex_s,
        "workers_needed_for_headline": int(np.ceil(headline_ex_s * per_example_s)),
        "sustains_headline": bool(sustained > headline_ex_s),
        "margin_x": round(sustained / headline_ex_s, 2),
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--headline", type=float, required=True,
                    help="examples/s the host must feed: a step rate measured on the card "
                         "(e.g. chip_smoke.py phase train's ex/s), with its card's name")
    ap.add_argument("--workers", type=int, default=16,
                    help="loader worker threads on the modeled host")
    ap.add_argument("--out", default=None, help="write JSON here")
    flags = ap.parse_args(argv)

    measured = measure_host_costs()
    report = {
        "what": "host input-pipeline cost model: per-example isolated op costs (the "
                "loader's host path) and the sustained-feed bound, on this host",
        "cpus": os.cpu_count(),
        "measured": measured,
        "model_this_host": cost_model(measured, flags.headline, flags.workers),
    }
    text = json.dumps(report, indent=1)
    print(text)
    if flags.out:
        with open(flags.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
