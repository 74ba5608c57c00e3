"""HTTP inference server over an exported serving artifact.

Counterpart of ``climb_tpu/serve/server.py``. The deployable unit is the
single-file artifact of ``predict --export_model`` (``torch.export`` programs,
parameters and the input signature, :mod:`climb_tpu_torch.serve.export`).
Each program has one fixed batch signature, so the server coalesces
concurrent requests into device batches (continuous micro-batching) instead
of running one under-filled forward per request, and pads each batch only to
the smallest program of the artifact's batch-size ladder that holds it, its
canvas cropped to the smallest program of the width ladder.

Stack: Python stdlib only (``http.server.ThreadingHTTPServer``). Request
threads do the host-side work in parallel (JSON parse, image decode,
tokenize through the input processor); a single batcher thread drains the
example queue up to the artifact's batch size (or ``max_wait_ms``),
zero-fills the signature keys serving does not provide (labels), pads the
tail, and runs the exported program once per batch. That thread is the only
one that touches the card: it copies each assembled batch to the
artifact's device, runs the program and copies the logits back.

API:
  GET  /healthz      -> {status, task_key, batch_size, signature, platforms}
  GET  /stats        -> batching counters (requests, examples, batches,
                        mean batch fill, last batch latency)
  POST /v1/predict   -> body {"instances": [...], "return_logits": bool}
       instance schema matches predict --input_jsonl rows:
         {"text": str, "image": IMG}                  single-image tasks
         {"text": str, "images": [IMG, IMG]}          NLVR2-style pairs
         {"choices": [str, ...], "image": IMG}        multiple choice
       IMG = local path string | {"b64": base64-encoded image bytes}
             | nested uint8 HWC array
       -> {"predictions": [int, ...], "n": int, ["logits": [[...]]]}
"""

import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from climb_tpu_torch.serve.export import WIDTH_AXIS, pick_from_ladder

logger = logging.getLogger(__name__)

_STOP = object()


class OverloadedError(RuntimeError):
    """Submission rejected because the inference queue is full (HTTP 503)."""


class RequestBatcher:
    """Coalesce single-example submissions into fixed-size device batches.

    ``run_fn(batch_dict) -> (logits, ...)`` is invoked on one thread only
    (the batcher), with every batch padded and zero-filled to
    ``batch_spec``'s signature and, when ``device`` is given, copied there
    first. ``submit(example)`` blocks the calling (request) thread until its
    row of logits (a numpy array) is available.
    """

    def __init__(self, run_fn, batch_spec, max_wait_ms: float = 5.0,
                 submit_timeout_s: float = 120.0, max_queued_batches: int = 16,
                 batch_size_ladder=None, canvas_width_ladder=None,
                 patch_size: int = 32, device=None):
        self._run_fn = run_fn
        self.device = None if device is None else torch.device(device)
        self.batch_spec = dict(batch_spec)  # {key: (shape, dtype_name)}
        self.batch_size = next(iter(self.batch_spec.values()))[0][0]
        # batch-size ladder (multi-program artifacts): pad a partial batch
        # only to the smallest program that fits it, instead of the full
        # signature batch — a lightly loaded server answers a single request
        # with the bs=1 program's latency, not the bs=64 program's
        self.batch_size_ladder = tuple(
            sorted(batch_size_ladder or (self.batch_size,))
        )
        # canvas-width ladder (the serving analog of aspect bucketing): crop
        # each assembled batch's pixel canvas to the smallest program width
        # holding every row's valid patches (patch_hw) — 4:3 photos stop
        # paying the full-canvas padding FLOPs per request
        self.canvas_width_ladder = (
            tuple(sorted(canvas_width_ladder)) if canvas_width_ladder else None
        )
        self.patch_size = int(patch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self.submit_timeout_s = submit_timeout_s
        # bounded: under sustained overload new submissions fail fast
        # (OverloadedError -> 503) instead of queueing unboundedly
        self._q = queue.Queue(maxsize=max_queued_batches * self.batch_size)
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "examples": 0, "batches": 0,
                      "batched_examples": 0, "last_batch_ms": None,
                      "last_batch_size": None, "last_batch_width": None,
                      "errors": 0, "rejected": 0, "abandoned": 0, "programs": {}}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="climb-batcher")
        self._thread.start()

    # -- request side ------------------------------------------------------
    def validate_example(self, example: dict) -> None:
        """Per-example shape/dtype check against the signature, so one bad
        row fails ITS request at submit time rather than poisoning the whole
        coalesced device batch (which may carry other clients' examples)."""
        for key, (shape, _) in self.batch_spec.items():
            if key in example:
                got = tuple(np.shape(example[key]))
                if got != tuple(shape)[1:]:
                    raise ValueError(
                        f"'{key}' row shape {got} != artifact signature "
                        f"{tuple(shape)[1:]}"
                    )

    def submit(self, example: dict) -> np.ndarray:
        """Blockingly run one example; returns its logits row."""
        self.validate_example(example)
        done = threading.Event()
        item = {"example": example, "done": done, "result": None,
                "error": None, "abandoned": False}
        try:
            self._q.put(item, timeout=self.max_wait_s + 1.0)
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise OverloadedError(
                f"inference queue full ({self._q.maxsize} examples pending)"
            )
        if not done.wait(self.submit_timeout_s):
            item["abandoned"] = True  # batcher drops it instead of running it
            with self._lock:
                self.stats["abandoned"] += 1
            raise TimeoutError(
                f"inference did not complete in {self.submit_timeout_s:.0f}s"
            )
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self):
        self._q.put(_STOP)
        self._thread.join(timeout=10.0)

    # -- batcher side ------------------------------------------------------
    def _loop(self):
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            items = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(items) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self._fail(items, RuntimeError("server shutting down"))
                    return
                items.append(nxt)
            # don't burn device time on rows whose submitter already timed
            # out (nobody is waiting for the result)
            items = [it for it in items if not it["abandoned"]]
            if not items:
                continue
            try:
                batch = self._assemble([it["example"] for it in items])
                t0 = time.perf_counter()
                if self.device is not None:
                    batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                out = self._run_fn(batch)
                logits = out[0] if isinstance(out, (tuple, list)) else out
                logits = (logits.detach().float().cpu().numpy()
                          if isinstance(logits, torch.Tensor) else np.asarray(logits))
                dt_ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["batched_examples"] += len(items)
                    self.stats["last_batch_ms"] = round(dt_ms, 2)
                    self.stats["last_batch_size"] = int(
                        np.shape(next(iter(batch.values())))[0]
                    )
                    width = None
                    if "pixel_values" in batch:
                        width = int(batch["pixel_values"].shape[WIDTH_AXIS])
                        self.stats["last_batch_width"] = width
                    program = f"{self.stats['last_batch_size']}:{width or ''}"
                    programs = self.stats["programs"]
                    programs[program] = programs.get(program, 0) + 1
                for i, it in enumerate(items):
                    it["result"] = logits[i]
                    it["done"].set()
            except Exception as e:  # propagate to every waiting request
                logger.exception("batch failed")
                self._fail(items, e)

    def _fail(self, items, err):
        with self._lock:
            self.stats["errors"] += len(items)
        for it in items:
            it["error"] = err
            it["done"].set()

    def _width_for(self, examples):
        """Smallest width-ladder canvas holding every example's valid
        patches (from 'patch_hw'; the full canvas when absent)."""
        if self.canvas_width_ladder is None or len(self.canvas_width_ladder) < 2:
            return None
        needed = 0
        for ex in examples:
            phw = ex.get("patch_hw")
            if phw is None:
                return None
            needed = max(needed, int(np.max(np.asarray(phw)[..., 1])))
        return pick_from_ladder(self.canvas_width_ladder,
                                needed * self.patch_size)

    def _assemble(self, examples) -> dict:
        n = len(examples)
        target = pick_from_ladder(self.batch_size_ladder, n)
        width = self._width_for(examples)
        batch = {}
        for key, (shape, dtype) in self.batch_spec.items():
            want = list(shape)[1:]
            if key == "pixel_values" and width is not None:
                want[WIDTH_AXIS] = width
            out = np.zeros((target,) + tuple(want), dtype)
            if key == "valid":
                out[:n] = 1.0
            elif key in examples[0]:
                rows = np.stack([np.asarray(ex[key]) for ex in examples])
                if key == "pixel_values" and width is not None:
                    # top-left-anchored canvas: columns beyond every row's
                    # valid patch width are padding — cropping is lossless
                    rows = np.ascontiguousarray(rows[..., :width, :])
                if rows.shape[1:] != tuple(want):
                    raise ValueError(
                        f"'{key}' row shape {rows.shape[1:]} != artifact "
                        f"signature {tuple(want)}"
                    )
                out[:n] = rows.astype(dtype)
            # else: signature key the request never carries (labels,
            # target_scores) stays zero — serving computes logits only
            batch[key] = out
        return batch


class InferenceService:
    """Instances -> processor -> batcher -> per-example logits."""

    def __init__(self, exported, tokenizer=None, max_wait_ms: float = 5.0):
        from concurrent.futures import ThreadPoolExecutor

        from climb_tpu_torch.data.processor import ViltInputProcessor
        from climb_tpu_torch.data.tokenization import load_tokenizer

        self.exported = exported
        meta = exported.meta
        self.meta = meta
        self.processor = ViltInputProcessor(
            tokenizer or load_tokenizer(meta.get("tokenizer", "bert-base-uncased")),
            int(meta["max_text_len"]),
            (int(meta["image_height"]), int(meta["image_width"])),
            int(meta["patch_size"]),
        )
        self.batcher = RequestBatcher(
            exported, exported.batch_spec, max_wait_ms=max_wait_ms,
            batch_size_ladder=getattr(exported, "batch_sizes", None),
            canvas_width_ladder=getattr(exported, "canvas_widths", None),
            patch_size=int(meta.get("patch_size", 32) or 32),
            device=getattr(exported, "device", None),
        )
        # bounded fan-out for multi-instance requests: enough in-flight
        # submissions to fill a few device batches, not a thread per row
        self._pool = ThreadPoolExecutor(
            max_workers=4 * self.batcher.batch_size,
            thread_name_prefix="climb-submit",
        )

    def preprocess(self, instances) -> list:
        """Instances -> list of per-example dicts (processor output rows).
        Shares the schema dispatch with predict --input_jsonl
        (data/processor.py::build_raw_batch)."""
        from climb_tpu_torch.data.processor import build_raw_batch

        meta = self.meta
        try:
            batch = build_raw_batch(
                self.processor, meta.get("model_type", "classification"),
                int(meta.get("num_images", 1)), instances,
                num_choices=int(meta.get("num_choices") or 0) or None,
            )
        except (AttributeError, IndexError) as e:
            # payload-shaped data reaching the processor with wrong types —
            # a CLIENT error (re-raised as such); server-side bugs outside
            # preprocess keep raising their own types into the 500 path
            raise ValueError(f"malformed instance: {type(e).__name__}: {e}")
        n = len(instances)
        return [{k: v[i] for k, v in batch.items()} for i in range(n)]

    def predict(self, instances, return_logits=False) -> dict:
        with self.batcher._lock:
            self.batcher.stats["requests"] += 1
            self.batcher.stats["examples"] += len(instances)
        rows = self.preprocess(instances)
        if len(rows) == 1:
            logits = [self.batcher.submit(rows[0])]
        else:
            # submit concurrently (bounded pool) so one request's examples
            # share batches with each other and other in-flight requests
            futures = [self._pool.submit(self.batcher.submit, r) for r in rows]
            logits = [f.result() for f in futures]
        out = {
            "task_key": self.meta.get("task_key"),
            "predictions": [int(np.argmax(l)) for l in logits],
            "n": len(rows),
        }
        if return_logits:
            out["logits"] = [np.asarray(l, np.float64).tolist() for l in logits]
        return out

    def close(self):
        self._pool.shutdown(wait=False)
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    # class attrs injected by create_server: the default service plus the
    # task-key routing table (multi-task servers carry several artifacts)
    service: InferenceService = None
    services: dict = None

    def _route(self, task):
        """Pick the service for a request's 'task' field (None = default
        when unambiguous)."""
        if task is None:
            if len(self.services) == 1:
                return self.service
            raise ValueError(
                f"this server carries several tasks {sorted(self.services)}; "
                f"the request body must set 'task'"
            )
        svc = self.services.get(task)
        if svc is None:
            raise ValueError(
                f"unknown task '{task}'; this server carries "
                f"{sorted(self.services)}"
            )
        return svc

    def log_message(self, fmt, *args):  # route http.server noise to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        svc = self.service
        if self.path == "/healthz":
            payload = {
                "status": "ok",
                "task_key": svc.meta.get("task_key"),
                "batch_size": svc.batcher.batch_size,
                "platforms": list(svc.exported.platforms),
                "signature": {
                    k: [list(shape), dtype]
                    for k, (shape, dtype) in svc.exported.batch_spec.items()
                },
            }
            if len(self.services) > 1:
                payload["tasks"] = sorted(self.services)
            self._json(200, payload)
        elif self.path == "/stats":
            def one(s):
                with s.batcher._lock:
                    stats = dict(s.batcher.stats)
                b = max(stats["batches"], 1)
                stats["mean_batch_fill"] = round(
                    stats["batched_examples"] / b / s.batcher.batch_size, 3)
                return stats

            if len(self.services) > 1:
                self._json(200, {t: one(s) for t, s in self.services.items()})
            else:
                self._json(200, one(svc))
        else:
            self._json(404, {"error": f"no route {self.path}"})

    MAX_BODY_BYTES = 256 * 1024 * 1024
    # per-request instances bound (overridable via create_server): without
    # it one huge request would preprocess every row into host arrays and
    # flood the submit pool's unbounded future queue BEFORE the batcher's
    # bounded example queue could push back — the 503 backpressure must
    # engage per request too, not just per example
    MAX_INSTANCES = 1024
    timeout = 300  # socket timeout: a stalled client can't pin the thread

    def do_POST(self):
        if self.path != "/v1/predict":
            return self._json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                return self._json(400, {"error": "invalid Content-Length"})
            if length > self.MAX_BODY_BYTES:
                return self._json(413, {
                    "error": f"request body {length} bytes exceeds "
                             f"{self.MAX_BODY_BYTES}"})
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            instances = req.get("instances")
            if not isinstance(instances, list) or not instances:
                raise ValueError("body must carry a non-empty 'instances' list")
            if len(instances) > self.MAX_INSTANCES:
                return self._json(413, {
                    "error": f"{len(instances)} instances exceeds the "
                             f"per-request limit {self.MAX_INSTANCES}; "
                             f"split the request"})
            if not all(isinstance(i, dict) for i in instances):
                raise ValueError("every instance must be a JSON object")
            out = self._route(req.get("task")).predict(
                instances, return_logits=bool(req.get("return_logits"))
            )
            self._json(200, out)
        except OverloadedError as e:
            self._json(503, {"error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            # client errors from the json/validate layers (preprocess wraps
            # ITS payload-shaped failures into ValueError — see
            # InferenceService.preprocess — so a genuine server bug raising
            # AttributeError/IndexError still reaches the logged 500 path)
            logger.debug("client error: %s", e)
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            logger.exception("predict failed")
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def create_server(artifact_path, host: str = "127.0.0.1", port: int = 0,
                  max_wait_ms: float = 5.0, tokenizer=None,
                  warmup: bool = True,
                  max_instances: int = None, device="cuda") -> ThreadingHTTPServer:
    """Build a ready-to-serve ThreadingHTTPServer around artifact(s).

    ``artifact_path`` may be one path or a list — a MULTI-TASK server (the
    natural deployment of an upstream-CL run: every task's exported head
    behind one endpoint); requests route by their ``task`` field (optional
    when only one artifact is loaded). Task keys must be distinct.

    ``port=0`` binds an ephemeral port (``server.server_address[1]``).
    ``warmup`` runs one zero batch through every program so the first
    request doesn't pay any lazy initialization. The server owns the
    services; use ``server.service`` (default task) / ``server.services``
    for in-process access and call ``server.shutdown()`` +
    ``server.service.close()`` to stop (close() on each for multi-task).
    The programs run on ``device`` (the card unless 'cpu'; without a card
    'cuda' raises).
    """
    from climb_tpu_torch.serve.export import ExportedModel

    paths = ([artifact_path] if isinstance(artifact_path, (str, os.PathLike))
             else list(artifact_path))
    services = {}
    for p in paths:
        exported = ExportedModel(p, device)
        task = exported.meta.get("task_key")
        if task in services:
            raise ValueError(f"duplicate task '{task}' across artifacts {paths}")
        services[task] = InferenceService(exported, tokenizer=tokenizer,
                                          max_wait_ms=max_wait_ms)
        if warmup:
            # every (batch_size, canvas_width) program runs once, so that no
            # request pays a first call's set-up
            exported.warmup()
    service = next(iter(services.values()))
    attrs = {"service": service, "services": services}
    if max_instances is not None:
        attrs["MAX_INSTANCES"] = int(max_instances)
    handler = type("Handler", (_Handler,), attrs)
    server = ThreadingHTTPServer((host, port), handler)
    # graceful drain: server_close() joins in-flight handler threads instead
    # of abandoning daemon threads mid-response (the per-socket timeout
    # bounds how long a stuck client can delay shutdown)
    server.daemon_threads = False
    server.block_on_close = True
    server.service = service
    server.services = services
    logger.info(
        "serving %s (tasks=%s, batch=%d, wait<=%.1fms) on http://%s:%d",
        paths, sorted(services), service.batcher.batch_size, max_wait_ms,
        *server.server_address[:2],
    )
    return server
