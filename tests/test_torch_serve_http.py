"""climb_tpu_torch.serve.server on the CPU, over a loopback socket.

The cases of tests/test_http_serving.py against the port's server: an
exported artifact behind the request-coalescing batcher reproduces the
program's direct outputs, fills device batches from concurrent requests and
small programs of the ladder, answers bad requests with 4xx errors, drains on
SIGTERM, routes several tasks, and survives malformed payloads. Its
predictions for raw rows equal the JAX CLI's eager ``--input_jsonl``
predictions from the same checkpoint.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from climb_tpu.cli.predict import main as jax_predict
from climb_tpu_torch.cli.predict import main as port_predict
from climb_tpu_torch.data.processor import ViltInputProcessor
from climb_tpu_torch.data.tokenization import WordPieceTokenizer
from climb_tpu_torch.serve.export import ExportedModel
from climb_tpu_torch.serve.server import OverloadedError, RequestBatcher, create_server
from test_torch_data_common import jit_flax_init
from test_torch_serve_predict import N_ROWS, TASKS, _argv, checkpoint, rows  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BS = 4


@pytest.fixture(scope="module")
def artifacts(checkpoint, rows, tmp_path_factory):  # noqa: F811
    """The snli-ve artifact of the checkpoint (CPU programs at batch 4 and 1)
    and its vcr artifact (batch 4), and the JAX CLI's eager snli-ve
    predictions."""
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for task, ladder in (("snli-ve", ("--export_batch_sizes", "1")), ("vcr", ())):
        paths[task] = str(out / f"{task}.pt2")
        port_predict(_argv(task, out, checkpoint, "export", "--input_jsonl", str(rows[task]),
                           "--vocab_path", str(rows["vocab"]), "--device", "cpu",
                           "--export_model", paths[task], "--export_platforms", "cpu",
                           *ladder))
    mp = pytest.MonkeyPatch()
    jit_flax_init(mp)
    ref = jax_predict(_argv("snli-ve", out, checkpoint, "jax", "--input_jsonl",
                            str(rows["snli-ve"]), "--vocab_path", str(rows["vocab"])))
    mp.undo()
    return paths, ref["predictions"]


@pytest.fixture(scope="module")
def tokenizer(rows):  # noqa: F811
    return WordPieceTokenizer.from_vocab_file(str(rows["vocab"]))


@pytest.fixture(scope="module")
def server(artifacts, tokenizer):
    srv = create_server(artifacts[0]["snli-ve"], port=0, max_wait_ms=300.0, tokenizer=tokenizer,
                        device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.service.close()


def _url(server, route):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{route}"


def _post(server, payload, route="/v1/predict"):
    req = urllib.request.Request(_url(server, route), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=180) as r:
        return r.status, json.loads(r.read())


def _instances(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"text": f"a photo of {('two dogs', 'the cat', 'a red ball')[i % 3]}",
             "image": rng.randint(0, 255, (40, 56, 3)).astype(np.uint8).tolist()}
            for i in range(n)]


_LOADED = {}


def _direct_logits(path, tokenizer, instances):
    """Ground truth: the same preprocessing, one direct ExportedModel call
    per instance at the signature batch."""
    m = _LOADED.get(path) or _LOADED.setdefault(path, ExportedModel(path, "cpu"))
    proc = ViltInputProcessor(tokenizer, int(m.meta["max_text_len"]), (64, 96), 32)
    out = []
    for r in instances:
        b = proc([r["text"]], [np.asarray(r["image"], np.uint8)])
        full = {}
        for k, (shape, dtype) in m.batch_spec.items():
            full[k] = np.zeros(tuple(shape), dtype)
            if k in b:
                full[k][:1] = b[k].astype(dtype)
        out.append(m(full)[0][0].numpy())
    return out


def test_healthz_and_single_prediction(server, artifacts, tokenizer):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["task_key"] == "snli-ve"
    assert health["batch_size"] == BS and health["platforms"] == ["cpu"]
    assert health["signature"]["pixel_values"] == [[BS, 64, 96, 3], "uint8"]
    inst = _instances(1)
    status, out = _post(server, {"instances": inst, "return_logits": True})
    assert status == 200 and out["n"] == 1 and len(out["predictions"]) == 1
    want = _direct_logits(artifacts[0]["snli-ve"], tokenizer, inst)[0]
    # the batch-1 program of the ladder against the batch-4 one
    np.testing.assert_allclose(np.asarray(out["logits"][0]), want, rtol=1e-6, atol=1e-6)
    assert out["predictions"][0] == int(np.argmax(want))


def test_multi_instance_request_spans_batches(server, artifacts, tokenizer):
    inst = _instances(BS + 2, seed=1)  # at least two device batches
    status, out = _post(server, {"instances": inst, "return_logits": True})
    assert status == 200 and out["n"] == BS + 2
    want = _direct_logits(artifacts[0]["snli-ve"], tokenizer, inst)
    for got, exp in zip(out["logits"], want):
        np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-6, atol=1e-6)


def test_predictions_equal_jax_eager_predict(server, artifacts, rows):  # noqa: F811
    """The rows of predict --input_jsonl, three requests of mixed sizes: the
    server's predictions are the JAX CLI's eager ones."""
    lines = [json.loads(x) for x in Path(rows["snli-ve"]).read_text().splitlines()]
    preds = []
    for chunk in (lines[:1], lines[1:4], lines[4:]):
        status, out = _post(server, {"instances": chunk})
        assert status == 200
        preds += out["predictions"]
    assert len(preds) == N_ROWS
    assert preds == artifacts[1]
    with urllib.request.urlopen(_url(server, "/stats"), timeout=60) as r:
        stats = json.loads(r.read())
    assert set(stats["programs"]) <= {"1:96", "4:96"}
    assert stats["programs"].get("1:96", 0) >= 1  # a lone example ran the batch-1 program


def test_concurrent_requests_coalesce(artifacts, tokenizer):
    srv = create_server(artifacts[0]["snli-ve"], port=0, max_wait_ms=3000.0,
                        tokenizer=tokenizer, warmup=False, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        results = [None] * BS

        def call(i):
            results[i] = _post(srv, {"instances": _instances(1, seed=10 + i)})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(BS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert all(r[0] == 200 for r in results)
        with srv.service.batcher._lock:
            stats = dict(srv.service.batcher.stats)
        assert stats["batched_examples"] == BS
        assert stats["batches"] < BS  # four one-example requests share batches
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()


def _status(server, payload, route="/v1/predict"):
    try:
        _post(server, payload, route)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    return 200, None


def test_error_responses(server):
    status, body = _status(server, {"instances": []})
    assert status == 400 and "instances" in body["error"]
    status, body = _status(server, {"instances": [{"text": "no image"}]})
    assert status == 400 and "missing" in body["error"]
    status, _ = _status(server, {"instances": _instances(1)}, route="/nope")
    assert status == 404


def test_unreadable_image_is_a_client_error(server):
    for image in ("/no/such/file.jpg", {"b64": "bm90IGFuIGltYWdl"}):
        status, body = _status(server, {"instances": [{"text": "hi", "image": image}]})
        assert status == 400 and "unreadable image" in body["error"]


def test_batcher_overload_and_abandonment():
    """A full queue rejects at once (503) instead of growing, and rows whose
    submitter timed out never reach the device."""
    ran = []
    gate = threading.Event()

    def slow_run(batch):
        gate.wait(10.0)
        ran.append(int(np.asarray(batch["valid"]).sum()))
        return (np.zeros((2, 3), np.float32),)

    spec = {"x": ((2, 3), "float32"), "valid": ((2,), "float32")}
    b = RequestBatcher(slow_run, spec, max_wait_ms=1.0, submit_timeout_s=0.2,
                       max_queued_batches=1)
    try:
        first = threading.Thread(target=lambda: pytest.raises(
            TimeoutError, b.submit, {"x": np.zeros(3, np.float32)}))
        first.start()
        time.sleep(0.05)
        fillers = [threading.Thread(target=lambda: pytest.raises(
            TimeoutError, b.submit, {"x": np.zeros(3, np.float32)})) for _ in range(2)]
        for th in fillers:
            th.start()
        time.sleep(0.1)
        with pytest.raises(OverloadedError, match="queue full"):
            b.submit({"x": np.zeros(3, np.float32)})
        first.join()
        for th in fillers:
            th.join()
        gate.set()
        time.sleep(0.3)
        with b._lock:
            stats = dict(b.stats)
        assert stats["rejected"] >= 1 and stats["abandoned"] >= 2
        assert stats["batched_examples"] <= 1  # only the row taken before the timeouts
    finally:
        gate.set()
        b.close()


def test_batcher_zero_fills_signature_and_moves_batches():
    calls = []

    def run_fn(batch):
        calls.append(batch)
        return (torch.arange(8, dtype=torch.float32).reshape(4, 2),)

    spec = {"x": ((4, 3), "float32"), "labels": ((4,), "int32"), "valid": ((4,), "float32")}
    b = RequestBatcher(run_fn, spec, max_wait_ms=50.0, device="cpu")
    try:
        row = b.submit({"x": np.ones((3,), np.float32)})
        assert isinstance(row, np.ndarray) and row.shape == (2,)
        sent = calls[0]
        assert all(isinstance(v, torch.Tensor) for v in sent.values())  # on the device
        np.testing.assert_array_equal(sent["valid"].numpy(), [1, 0, 0, 0])
        np.testing.assert_array_equal(sent["labels"].numpy(), np.zeros(4, np.int32))
        np.testing.assert_array_equal(sent["x"][0].numpy(), np.ones(3))
        np.testing.assert_array_equal(sent["x"][1:].numpy(), np.zeros((3, 3)))
        with pytest.raises(ValueError, match="signature"):
            b.submit({"x": np.ones((5,), np.float32)})
    finally:
        b.close()


def test_serve_cli_sigterm_drains(artifacts, rows):  # noqa: F811
    """``python -m climb_tpu_torch.cli.serve`` answers, then exits 0 on
    SIGTERM after draining."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "climb_tpu_torch.cli.serve", "--from_export",
         artifacts[0]["snli-ve"], "--port", "0", "--device", "cpu", "--vocab_path",
         str(rows["vocab"])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if "ready: POST" in line:
                port = int(line.rsplit(":", 1)[-1].split("/")[0])
                break
        assert port, "server never became ready:\n" + "".join(lines)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                     data=json.dumps({"instances": _instances(1)}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["n"] == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "draining" in out + "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_multi_task_server(artifacts, tokenizer):
    """One server, two task artifacts: requests route by 'task'; a taskless
    or unknown task is a 400; /healthz and /stats list both."""
    paths = artifacts[0]
    srv = create_server([paths["snli-ve"], paths["vcr"]], port=0, max_wait_ms=100.0,
                        tokenizer=tokenizer, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(_url(srv, "/healthz"), timeout=60) as r:
            assert json.loads(r.read())["tasks"] == ["snli-ve", "vcr"]
        inst = _instances(2)
        status, out = _post(srv, {"instances": inst, "task": "snli-ve", "return_logits": True})
        assert status == 200 and out["task_key"] == "snli-ve"
        for got, exp in zip(out["logits"], _direct_logits(paths["snli-ve"], tokenizer, inst)):
            np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-6, atol=1e-6)
        mc = [{"choices": ["a", "b", "c", "d"], "image": i["image"]} for i in inst]
        status, out = _post(srv, {"instances": mc, "task": "vcr", "return_logits": True})
        assert status == 200 and out["task_key"] == "vcr" and len(out["logits"][0]) == 4
        status, body = _status(srv, {"instances": inst})
        assert status == 400 and "task" in body["error"]
        status, _ = _status(srv, {"instances": inst, "task": "nope"})
        assert status == 400
        with urllib.request.urlopen(_url(srv, "/stats"), timeout=60) as r:
            stats = json.loads(r.read())
        assert set(stats) == {"snli-ve", "vcr"} and stats["vcr"]["examples"] >= 2
    finally:
        srv.shutdown()
        srv.server_close()
        for svc in srv.services.values():
            svc.close()


FUZZ_PAYLOADS = [
    b"", b"not json at all {{{", b"[1, 2, 3]", b'"just a string"', b"null",
    b'{"instances": "not-a-list"}', b'{"instances": [42]}', b'{"instances": ["text"]}',
    b'{"instances": [null]}', b'{"instances": [{}]}',
    b'{"instances": [{"text": 17, "image": 3}]}',
    b'{"instances": [{"text": "x", "image": {"b64": "!!!notbase64"}}]}',
    b'{"instances": [{"text": "x", "image": {"b64": ""}}]}',
    b'{"instances": [{"text": "x", "image": [[[1]]], "extra": {"a": [1]}}]}',
    b'{"instances": [{"choices": [], "image": [[[1]]]}]}',
    b'{"instances": [{"text": "' + b"x" * 100000 + b'", "image": 1}]}',
    b'{"task": {"nested": true}, "instances": [{"text": "x"}]}',
]


@pytest.mark.parametrize("payload", FUZZ_PAYLOADS, ids=range(len(FUZZ_PAYLOADS)))
def test_malformed_payload_fuzz(server, payload):
    """Every malformed body gets a 4xx JSON error, never a 5xx or a hang."""
    req = urllib.request.Request(_url(server, "/v1/predict"), data=payload,
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            pytest.fail(f"malformed payload accepted: {r.status}")
    except urllib.error.HTTPError as e:
        body = json.loads(e.read())
        assert 400 <= e.code < 500, (e.code, body)
        assert isinstance(body.get("error"), str) and body["error"]


def test_server_survives_fuzz_then_serves(server):
    status, body = _post(server, {"instances": _instances(1)})
    assert status == 200 and body["n"] == 1


def test_instances_per_request_bound(server, artifacts, tokenizer):
    status, body = _status(server, {"instances": [{"text": "x", "image": 1}] * 2000})
    assert status == 413 and "per-request limit" in body["error"]
    srv = create_server(artifacts[0]["snli-ve"], port=0, max_wait_ms=50.0, tokenizer=tokenizer,
                        max_instances=2, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert _status(srv, {"instances": _instances(3)})[0] == 413
        status, body = _post(srv, {"instances": _instances(2)})
        assert status == 200 and body["n"] == 2
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()


def test_server_on_cuda_without_card_raises(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        create_server(artifacts[0]["snli-ve"], port=0)  # the card by default
