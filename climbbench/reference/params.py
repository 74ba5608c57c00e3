"""The parameter tree of a configuration: every tensor's name, shape and the
normal distribution the benchmark draws it from.

The names are the JAX tree's, which the program under test also uses
(``vilt.*`` or ``viltbert.{vilt,bert}.*``, ``head_<task>.*``); the reference
reads the tensors by them. Dense weights are (out, in). Every tensor is
drawn, biases and LayerNorm scales included, so that every leaf carries a
gradient and nothing starts at a value that hides a fault.
"""


def _dense(name, n_in, n_out):
    return [(name + ".weight", (n_out, n_in), n_in ** -0.5, 0.0),
            (name + ".bias", (n_out,), 0.02, 0.0)]


def _norm(name, d):
    return [(name + ".weight", (d,), 0.02, 1.0), (name + ".bias", (d,), 0.02, 0.0)]


def _vilt(cfg, pre):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    grid = (cfg["image_size"] // cfg["patch_size"]) ** 2
    spec = [
        (pre + "word_embeddings.weight", (cfg["vocab_size"], d), 0.02, 0.0),
        (pre + "text_position_embeddings", (cfg["max_position_embeddings"], d), 0.02, 0.0),
        (pre + "token_type_embeddings.weight", (cfg["type_vocab_size"], d), 0.02, 0.0),
        *_norm(pre + "text_layernorm", d),
        *_dense(pre + "patch_projection", cfg["patch_size"] ** 2 * cfg["num_channels"], d),
        (pre + "visual_position_embeddings", (grid + 1, d), 0.02, 0.0),
        (pre + "cls_token", (1, 1, d), 0.02, 0.0),
        (pre + "modality_type_embeddings.weight", (cfg["modality_type_vocab_size"], d), 0.02,
         0.0),
    ]
    for i in range(cfg["num_hidden_layers"]):
        blk = f"{pre}encoder.{i}."
        spec += _norm(blk + "ln1", d)
        for n in ("q", "k", "v", "attn_out"):
            spec += _dense(blk + n, d, d)
        spec += _norm(blk + "ln2", d) + _dense(blk + "fc1", d, f) + _dense(blk + "fc2", f, d)
    return spec + _norm(pre + "final_layernorm", d) + _dense(pre + "pooler", d, d)


def _bert(cfg, pre):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    spec = [
        (pre + "word_embeddings.weight", (cfg["vocab_size"], d), 0.02, 0.0),
        (pre + "position_embeddings.weight", (cfg["max_position_embeddings"], d), 0.02, 0.0),
        (pre + "token_type_embeddings.weight", (cfg["type_vocab_size"], d), 0.02, 0.0),
        *_norm(pre + "embed_layernorm", d),
    ]
    for i in range(cfg["num_hidden_layers"]):
        blk = f"{pre}encoder.{i}."
        for n in ("q", "k", "v", "attn_out"):
            spec += _dense(blk + n, d, d)
        spec += (_norm(blk + "attn_ln", d) + _dense(blk + "fc1", d, f)
                 + _dense(blk + "fc2", f, d) + _norm(blk + "mlp_ln", d))
    return spec


def param_spec(config, task, num_labels):
    """[(name, shape, std, mean)] of the learner for one task's head."""
    d = config["hidden_size"]
    if config["model"] == "viltbert":
        spec = _bert(config["bert"], "viltbert.bert.") + _vilt(config, "viltbert.vilt.")
    else:
        spec = _vilt(config, "vilt.")
    head = "head_" + task.replace("-", "_")
    return (spec + _dense(head + ".fc1", d, 2 * d) + _norm(head + ".ln", 2 * d)
            + _dense(head + ".fc2", 2 * d, num_labels))


def frozen(name):
    """True for the parameters the configuration never trains (BERT's)."""
    return "bert" in name.split(".")


def decays(name):
    """CLiMB's AdamW grouping: no weight decay for biases and the HF
    ``LayerNorm`` scales (the text embeddings' and BERT's); ViLT's block,
    final and head LayerNorm scales decay."""
    parts = name.split(".")
    if parts[-1] == "bias" or parts[-2:] == ["text_layernorm", "weight"]:
        return False
    return not (frozen(name) and parts[-2] in ("embed_layernorm", "attn_ln", "mlp_ln"))
