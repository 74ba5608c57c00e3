"""Serve an exported artifact over HTTP (counterpart of ``climb_tpu/cli/serve.py``).

    python -m climb_tpu_torch.cli.serve --from_export snli-ve.pt2 --port 8700

The artifact (from ``climb_tpu_torch.cli.predict --export_model``) is the
deployment: no model code, checkpoint or dataset is needed at serve time, only
the port's kernel library, whose ops the programs call. Concurrent requests
are coalesced into fixed-shape device batches
(``climb_tpu_torch/serve/server.py``). Runs on the card unless ``--device
cpu`` is given. SIGTERM stops accepting and drains the requests in flight.
"""

import argparse
import logging

from climb_tpu_torch.cli.common import setup_logging

logger = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--from_export", required=True,
                   help="Serving artifact written by predict --export_model. "
                        "Comma-separate several to serve a MULTI-TASK "
                        "endpoint (e.g. every upstream CL task); requests "
                        "then route by their 'task' field.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700,
                   help="TCP port (0 = ephemeral; printed at startup).")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="How long the batcher waits to fill a device batch "
                        "before running a partial one.")
    p.add_argument("--tokenizer", default=None,
                   help="Override the artifact's tokenizer spec (name, vocab "
                        "file path, or 'synthetic').")
    p.add_argument("--vocab_path", default=None,
                   help="Explicit WordPiece vocab file for the tokenizer.")
    p.add_argument("--max_instances", type=int, default=1024,
                   help="Per-request instances bound (413 above it): keeps "
                        "one huge request from flooding host memory before "
                        "the batcher's bounded queue can push back.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default: the kernels on the card; raises without "
                        "one) or 'cpu' (the artifact's CPU programs).")
    return p


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)

    from climb_tpu_torch.serve.server import create_server

    tokenizer = None
    if args.tokenizer or args.vocab_path:
        from climb_tpu_torch.data.tokenization import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer or "bert-base-uncased",
                                   args.vocab_path)
    artifacts = [p for p in args.from_export.split(",") if p]
    server = create_server(artifacts if len(artifacts) > 1 else artifacts[0],
                           host=args.host, port=args.port,
                           max_wait_ms=args.max_wait_ms, tokenizer=tokenizer,
                           max_instances=args.max_instances, device=args.device)
    host, port = server.server_address[:2]
    logger.info("ready: POST http://%s:%d/v1/predict "
                "(GET /healthz, /stats; Ctrl-C or SIGTERM to stop)", host, port)

    # graceful stop on SIGTERM: stop accepting, let in-flight requests finish
    # (server_close joins handler threads: create_server sets
    # daemon_threads=False; the 300 s socket timeout bounds stragglers)
    import signal
    import threading

    def _on_term(signum, frame):
        logger.warning("signal %d: draining in-flight requests and stopping",
                       signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()  # drain: join in-flight handler threads
        for svc in server.services.values():
            svc.close()


if __name__ == "__main__":
    main()
