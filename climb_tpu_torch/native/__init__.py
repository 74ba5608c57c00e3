"""ctypes bindings for the native host-pipeline libraries (the port's copy of
``climb_tpu/native/__init__.py``).

- ``NativeWordPieceTokenizer``: the C++ WordPiece (ASCII fast path; the
  Python tokenizer for a call with non-ASCII text). Same ``encode`` and
  ``batch_encode`` as the Python tokenizer.
- ``resize_into_canvas``: C++ separable resampling straight into the fixed
  uint8 canvas, within 2 levels of PIL's resize.
- ``jpeg_dims`` and ``decode_jpeg``: libjpeg header reads and decodes.

The libraries build with g++ at the first call (``native/build.py``), not at
import. A function whose library is missing returns None, and its caller
leaves the step to PIL or Python, as in the JAX package.
"""

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_libs = None
_lock = threading.Lock()
_fork_hook = []

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "tokenizer": {
        "wp_create": (ctypes.c_void_p, [ctypes.c_char_p]),
        "wp_destroy": (None, [ctypes.c_void_p]),
        "wp_encode": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]),
        "wp_pad_id": (ctypes.c_int32, [ctypes.c_void_p]),
        "wp_sep_id": (ctypes.c_int32, [ctypes.c_void_p]),
        "wp_cls_id": (ctypes.c_int32, [ctypes.c_void_p]),
    },
    "image": {
        "img_resize_into_canvas": (ctypes.c_int, [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        "img_set_num_threads": (None, [ctypes.c_int]),
    },
    "jpeg": {
        "jpg_dims": (ctypes.c_int, [_U8P, ctypes.c_int, _IP, _IP]),
        "jpg_decode": (ctypes.c_int, [
            _U8P, ctypes.c_int, _U8P, ctypes.c_long, _IP, _IP]),
    },
}


def _one_thread_in_child():
    lib = (_libs or {}).get("image")
    if lib is not None:
        lib.img_set_num_threads(1)


def libraries() -> dict:
    """{library: bound ctypes library or None}, built and loaded at first use."""
    global _libs
    with _lock:
        if _libs is None:
            from climb_tpu_torch.native import build

            libs = {}
            for name, path in build.build().items():
                lib = None
                if path is not None:
                    try:
                        lib = ctypes.CDLL(str(path))
                    except OSError as e:
                        build.status[name] = f"failed: {e}"
                        logger.warning("failed to load %s: %s", path, e)
                if lib is not None:
                    for fn, (restype, argtypes) in _SIGNATURES[name].items():
                        getattr(lib, fn).restype = restype
                        getattr(lib, fn).argtypes = argtypes
                libs[name] = lib
            if libs["image"] is not None and not _fork_hook:
                # GNU OpenMP hangs in a forked child whose parent ran a
                # parallel region; see image_ops.cpp
                os.register_at_fork(after_in_child=_one_thread_in_child)
                _fork_hook.append(True)
            _libs = libs
    return _libs


def native_available() -> dict:
    return {name: lib is not None for name, lib in libraries().items()}


def jpeg_dims(data: bytes):
    """(height, width) from the JPEG header, or None if unavailable or invalid."""
    lib = libraries()["jpeg"]
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpg_dims(buf, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG bytes at full scale to an RGB8 (H, W, 3) array with
    libjpeg. Returns None when the library is missing or the data cannot be
    decoded natively (a CMYK JPEG: callers fall back to PIL)."""
    lib = libraries()["jpeg"]
    if lib is None:
        return None
    dims = jpeg_dims(data)
    if dims is None:
        return None
    oh, ow = dims
    out = np.empty((oh, ow, 3), np.uint8)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.jpg_decode(buf, len(data), out.ctypes.data_as(_U8P), out.nbytes,
                        ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or (h.value, w.value) != (oh, ow):
        return None
    return out


class NativeWordPieceTokenizer:
    """C++ WordPiece with the Python tokenizer for non-ASCII text."""

    def __init__(self, vocab_path: str):
        lib = libraries()["tokenizer"]
        if lib is None:
            raise RuntimeError("the native tokenizer library did not build")
        self._lib = lib
        self._h = lib.wp_create(vocab_path.encode())
        if not self._h:
            raise RuntimeError(f"failed to load vocab {vocab_path}")
        from climb_tpu_torch.data.tokenization import WordPieceTokenizer

        self._py = WordPieceTokenizer.from_vocab_file(vocab_path)
        self.pad_id = lib.wp_pad_id(self._h)
        self.sep_id = lib.wp_sep_id(self._h)
        self.cls_id = lib.wp_cls_id(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wp_destroy(h)
            self._h = None

    def encode(self, text: str, max_len: int, text_pair: Optional[str] = None):
        ids = np.empty((max_len,), np.int32)
        mask = np.empty((max_len,), np.float32)
        types = np.empty((max_len,), np.int32)
        rc = self._lib.wp_encode(
            self._h, text.encode(), text_pair.encode() if text_pair else None, max_len,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:  # non-ASCII text: the Python unicode path
            return self._py.encode(text, max_len, text_pair)
        return ids, mask, types

    def batch_encode(self, texts, max_len, pairs=None):
        outs = [self.encode(t, max_len, None if pairs is None else pairs[i])
                for i, t in enumerate(texts)]
        ids, mask, types = zip(*outs)
        return np.stack(ids), np.stack(mask), np.stack(types)


def resize_into_canvas(src: np.ndarray, out_hw, canvas_hw,
                       filter: str = "bicubic") -> Optional[np.ndarray]:
    """C++ resize of an HxWx3 uint8 array into a zeroed canvas; None if the
    library is missing."""
    lib = libraries()["image"]
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    h_in, w_in = src.shape[:2]
    h_out, w_out = out_hw
    ch, cw = canvas_hw
    dst = np.zeros((ch, cw, 3), np.uint8)
    rc = lib.img_resize_into_canvas(src.ctypes.data_as(_U8P), h_in, w_in, h_out, w_out,
                                    dst.ctypes.data_as(_U8P), ch, cw,
                                    1 if filter == "bicubic" else 0)
    return dst if rc == 0 else None
