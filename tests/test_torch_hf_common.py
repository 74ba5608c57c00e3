"""Set-up shared by the port's Hugging Face snapshot tests (no test here).

- ``no_network``: until the monkeypatch is undone, a socket connection to
  anything but the loopback raises, so a transformers call that would go to
  the hub fails here instead of reaching out.
- ``offline_hub``: points both packages at a hub cache directory: the port
  reads ``$HF_HUB_CACHE``; transformers and huggingface_hub read their cache
  path and offline switch once, at import, so their module values are set too.
- ``write_vilt_snapshot`` / ``write_bert_snapshot``: a hub-cache entry
  (``models--org--name/refs/main`` -> ``snapshots/<rev>/``, the weights a
  symlink into ``blobs/``) in the layout of ``dandelin/vilt-b32-mlm`` (a
  ``ViltForMaskedLM`` checkpoint: ``vilt.*`` keys and ``mlm_score.*``, in
  ``model.safetensors``) and of ``bert-base-uncased`` (a
  ``BertForPreTraining`` checkpoint in ``pytorch_model.bin``: ``bert.*`` keys
  with TF-era ``LayerNorm.gamma``/``beta`` names, and ``cls.*``; with
  ``vocab.txt`` and ``tokenizer_config.json``).
"""

import json
import os
import socket

import torch

# matches the tiny ViltConfig of both packages' vilt_config_from_args
VILT_TINY = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, image_size=64, patch_size=32,
                 max_position_embeddings=40, max_image_length=-1, modality_type_vocab_size=2)
BERT_TINY = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, max_position_embeddings=512)
REVISION = "0123456789abcdef0123456789abcdef01234567"


def no_network(mp):
    real_connect = socket.socket.connect

    def connect(self, address):
        host = address[0] if isinstance(address, tuple) else address
        if isinstance(host, str) and host not in ("127.0.0.1", "::1", "localhost") \
                and self.family in (socket.AF_INET, socket.AF_INET6):
            raise OSError(f"network disabled in this test: {address}")
        return real_connect(self, address)

    mp.setattr(socket.socket, "connect", connect)


def offline_hub(mp, hub: str):
    import huggingface_hub.constants
    import transformers.utils.hub

    no_network(mp)
    mp.setenv("HF_HUB_CACHE", str(hub))
    mp.setenv("HF_HUB_OFFLINE", "1")
    mp.setattr(huggingface_hub.constants, "HF_HUB_CACHE", str(hub))
    mp.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    mp.setattr(transformers.utils.hub, "TRANSFORMERS_CACHE", str(hub))
    mp.setattr(transformers.utils.hub, "_is_offline_mode", True)
    assert transformers.utils.hub.is_offline_mode()


def snapshot_dir(hub, repo_id: str) -> str:
    repo = os.path.join(str(hub), "models--" + repo_id.replace("/", "--"))
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(REVISION)
    snap = os.path.join(repo, "snapshots", REVISION)
    os.makedirs(snap, exist_ok=True)
    os.makedirs(os.path.join(repo, "blobs"), exist_ok=True)
    return snap


def link_blob(snap: str, name: str, write):
    """Write a file through ``write(path)`` into ``blobs/`` and link it as
    ``snap/name``, as the hub cache stores files."""
    blob = os.path.join(snap, "..", "..", "blobs", name + ".blob")
    write(blob)
    os.symlink(os.path.relpath(blob, snap), os.path.join(snap, name))


def write_vilt_snapshot(hub, hf_vilt_model, seed: int = 1) -> str:
    import transformers
    from safetensors.torch import save_file

    snap = snapshot_dir(hub, "dandelin/vilt-b32-mlm")
    cfg = transformers.ViltConfig(**VILT_TINY)
    cfg.architectures = ["ViltForMaskedLM"]
    cfg.to_json_file(os.path.join(snap, "config.json"))
    g = torch.Generator().manual_seed(seed)
    d, v = VILT_TINY["hidden_size"], VILT_TINY["vocab_size"]
    sd = {"vilt." + k: t.contiguous() for k, t in hf_vilt_model.state_dict().items()}
    sd.update({"mlm_score.dense.weight": torch.randn(d, d, generator=g),
               "mlm_score.dense.bias": torch.randn(d, generator=g),
               "mlm_score.bias": torch.randn(v, generator=g)})
    link_blob(snap, "model.safetensors", lambda p: save_file(sd, p))
    return snap


def write_bert_snapshot(hub, hf_bert_model, vocab_words, seed: int = 2,
                        do_lower_case: bool = True) -> str:
    import transformers

    snap = snapshot_dir(hub, "bert-base-uncased")
    cfg = transformers.BertConfig(**BERT_TINY)
    cfg.architectures = ["BertForPreTraining"]
    cfg.to_json_file(os.path.join(snap, "config.json"))
    g = torch.Generator().manual_seed(seed)
    d, v = BERT_TINY["hidden_size"], BERT_TINY["vocab_size"]
    sd = {}
    for k, t in hf_bert_model.state_dict().items():
        k = "bert." + k
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        sd[k] = t.clone()
    sd.update({"cls.predictions.bias": torch.randn(v, generator=g),
               "cls.predictions.transform.dense.weight": torch.randn(d, d, generator=g),
               "cls.seq_relationship.weight": torch.randn(2, d, generator=g)})
    link_blob(snap, "pytorch_model.bin", lambda p: torch.save(sd, p))
    write_vocab(snap, vocab_words, do_lower_case)
    return snap


def write_vocab(snap: str, words, do_lower_case: bool = True):
    with open(os.path.join(snap, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": do_lower_case, "model_max_length": 512}, f)
