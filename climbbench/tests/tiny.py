"""Overrides that cut a cell to a size a CPU test can hold: hidden 64, two
layers, four heads, FFN 128, a 2,048-word vocabulary, a 64 x 96 canvas, a
batch of 4 (the port's ``--tiny`` widths), in the cell's compute dtype
unless asked."""

import contextlib
import io
import json


def overrides(cell, dtype=None):
    from climbbench.common import HARNESS, Manifest

    manifest = Manifest(HARNESS.parent)
    dtype = dtype or manifest.config(manifest.cell(cell)["config"])["port"]["compute_dtype"]
    model = "viltbert" if cell.startswith("viltbert") else "vilt"
    port = {"encoder_name": model, "compute_dtype": dtype, "attn_impl": "auto",
            "mlp_impl": "xla", "dense_impl": "xla", "pretrained_model_name": "scratch",
            "tiny": True, "num_layers": 2}
    widths = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "vocab_size": 2048}
    config = {**widths, "image_size": 64, "port": port}
    if model == "viltbert":
        config["bert"] = {**widths, "max_position_embeddings": 512, "type_vocab_size": 2,
                          "layer_norm_eps": 1e-12}
    traffic = {"batch": 4, "pool": 4, "canvas": [64, 96],
               "aspect_mix": [[64, 64, 7], [64, 96, 2], [64, 32, 1]], "trace_steps": 2}
    return {"config": config, "traffic": traffic}


def run_cell(cell, seed=5, seconds=0.5, trace=0, dtype=None):
    """(exit code, the result line as a dict or None) of ``run.main`` on the
    CPU at the tiny size."""
    from climbbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", overrides=overrides(cell, dtype))
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None
