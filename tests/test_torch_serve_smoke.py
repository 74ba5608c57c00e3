"""chip_smoke.py's phase serve helpers on the CPU: each reads what its
counterpart writes. The rows it fabricates go through the port's raw-input
processor; its HTTP clients drive a loopback server and return every answer
with its rows; its summaries of latencies, int8 agreement and ties give the
values worked out by hand."""

import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from climb_tpu_torch.data.processor import ViltInputProcessor, build_raw_batch
from climb_tpu_torch.data.tokenization import load_tokenizer


@pytest.fixture(scope="module")
def predict_root(tmp_path_factory):
    """The predict root's layout at a few photos: Flickr30k JPEGs and the vocab."""
    root = str(tmp_path_factory.mktemp("root"))
    jobs = [(os.path.join(root, "flickr30k", "flickr30k_images", f"{i + 1}.jpg"),
             *chip_smoke.FLICKR_SIZES[i % 2]) for i in range(chip_smoke.FLICKR_IMAGES)]
    chip_smoke.save_photos(jobs, seed=1)
    chip_smoke.write_vocab(os.path.join(root, "vocab.txt"))
    return root


def test_serve_rows_read_back(predict_root, tmp_path):
    path = str(tmp_path / "rows.jsonl")
    rows = chip_smoke.write_serve_rows(predict_root, path, n=6)
    with open(path) as f:
        assert [json.loads(line) for line in f] == rows
    assert [isinstance(r["image"], str) for r in rows] == [True, False] * 3
    for r in rows[1::2]:  # the base64 rows carry a photo's bytes
        blob = base64.b64decode(r["image"]["b64"])
        assert blob[:2] == b"\xff\xd8" and any(
            open(os.path.join(predict_root, "flickr30k", "flickr30k_images", f), "rb").read()
            == blob for f in os.listdir(os.path.join(predict_root, "flickr30k",
                                                     "flickr30k_images")))
    assert {r["label"] for r in rows} <= {0, 1, 2}
    proc = ViltInputProcessor(load_tokenizer("bert-base-uncased",
                                             os.path.join(predict_root, "vocab.txt")),
                              chip_smoke.TEXT, chip_smoke.CANVAS[:2], 32)
    batch = build_raw_batch(proc, "classification", 1, rows)
    assert batch["pixel_values"].shape == (6,) + chip_smoke.CANVAS
    # Flickr30k's 500x375 photos fill 16 of the 20 patch columns, 375x500 ones 9
    assert set(batch["patch_hw"][:, 1].tolist()) <= {9, 16}
    assert max(batch["patch_hw"][:, 1]) * 32 <= chip_smoke.SERVE_WIDTH_LADDER[0]
    assert (batch["input_ids"][:, 0] == 2).all()  # [CLS] of the script's vocab


def test_serve_argv_parses(predict_root):
    from climb_tpu_torch.cli.predict import build_parser

    args = build_parser().parse_args(chip_smoke.serve_argv(
        predict_root, "ckpt", "rows.jsonl", "out", "eager", 8, "--dense_impl", "int8"))
    assert (args.input_jsonl, args.batch_size, args.dense_impl, args.device) == (
        "rows.jsonl", 8, "int8", "cuda")
    assert args.vocab_path == os.path.join(predict_root, "vocab.txt")


class _Echo(BaseHTTPRequestHandler):
    """Answers each instance with its text's length as the prediction."""

    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        inst = req["instances"]
        body = json.dumps({"n": len(inst), "predictions": [len(i["text"]) for i in inst],
                           "logits": [[0.0, 1.0] for _ in inst]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_serve_clients_return_every_answer():
    rows = [{"text": "x" * (i + 1), "image": "unused.jpg"} for i in range(20)]
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        wall, results = chip_smoke.serve_clients(f"http://{host}:{port}/v1/predict", rows,
                                                 clients=3, requests=4)
    finally:
        server.shutdown()
        server.server_close()
    assert len(results) == 12 and wall > 0
    for idx, latency, out in results:
        assert 1 <= len(idx) <= 4 and len(set(idx)) == len(idx) and latency > 0
        assert out["predictions"] == [len(rows[i]["text"]) for i in idx]
    with pytest.raises(AssertionError, match="serve clients failed"):
        chip_smoke.serve_clients(f"http://{host}:{port}/v1/predict", rows, clients=1,
                                 requests=1)  # the server is gone


def test_summaries():
    lat = chip_smoke.latency_summary([0.01 * i for i in range(1, 101)])
    assert lat["p50_ms"] == pytest.approx(500.0) and lat["p99_ms"] == pytest.approx(990.0)
    assert lat["mean_ms"] == pytest.approx(505.0) and lat["n"] == 100
    ref = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 1.9], [0.0, 0.0, 3.0], [5.0, 1.0, 0.0]])
    agree, corr = chip_smoke.int8_agreement(ref, ref[:, [0, 2, 1]])
    assert agree == 0.5 and corr < 1.0
    assert chip_smoke.int8_agreement(ref, 2 * ref) == (1.0, pytest.approx(1.0))
    assert chip_smoke.tie_rows(ref, 0.15) == {1}
    assert chip_smoke.tie_rows(ref, 1.0) == {0, 1}


def test_step_times_read_their_clocks():
    class Event:  # a host clock in place of a CUDA event
        def __init__(self, enable_timing=True):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    calls = []
    clock = SimpleNamespace(cuda=SimpleNamespace(Event=Event, synchronize=lambda: None))
    got = chip_smoke.step_times(clock, {
        "slow": lambda: (calls.append("slow"), time.sleep(0.004)),
        "fast": lambda: calls.append("fast")}, rounds=5, warmup=2)
    # the warm-up of each, then one step of each a round
    assert calls == ["slow"] * 2 + ["fast"] * 2 + ["slow", "fast"] * 5
    assert set(got) == {"slow", "fast"}
    assert 4.0 <= got["slow"]["events_ms"] < 100 and 4.0 <= got["slow"]["host_ms"] < 100
    assert got["fast"]["events_ms"] < got["slow"]["events_ms"]
    assert got["fast"]["host_ms"] < got["slow"]["host_ms"]
