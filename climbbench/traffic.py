"""The one traffic generator: a pool of batches made from the seed, on the
device, from a mix file's parameters.

Every seed gets the same multiset of sizes (image widths by the mix's
weights, text lengths spread evenly over their range, labels balanced), in
an order of its own, so the seed changes which rows meet and not how much
work a step holds. Images are uint8 on the fixed canvas, random inside each
image's valid region and zero outside; ``patch_hw`` marks the valid patch
grid. Texts are [CLS] word pieces [SEP], zero-padded to the model's text
positions.
"""

import torch

from climbbench.common import derive_seed


def spread(weights, n):
    """n items over len(weights) classes in proportion to the weights (the
    largest remainders get the leftovers)."""
    total = sum(weights)
    exact = [w * n / total for w in weights]
    counts = [int(x) for x in exact]
    order = sorted(range(len(weights)), key=lambda i: counts[i] - exact[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return torch.repeat_interleave(torch.arange(len(weights)), torch.tensor(counts))


def _shuffled(values, generator):
    return values[torch.randperm(len(values), generator=generator)]


def make_pool(traffic, config, seed, device):
    """``traffic["pool"]`` batches of ``traffic["batch"]`` rows on ``device``."""
    batch, n_batches = traffic["batch"], traffic["pool"]
    n = batch * n_batches
    height, width = traffic["canvas"]
    patch = config["patch_size"]
    text_len = config["max_position_embeddings"]
    host = torch.Generator().manual_seed(derive_seed(seed, "traffic.sizes"))

    mix = traffic["aspect_mix"]  # [height, width, weight]
    kind = _shuffled(spread([w for _, _, w in mix], n), host)
    image_hw = torch.tensor([[h, w] for h, w, _ in mix])[kind]
    lo, hi = traffic["text_tokens"]
    lengths = _shuffled(lo + spread([1] * (hi - lo + 1), n), host)
    labels = _shuffled(spread([1] * traffic["labels"], n), host)

    dev = torch.Generator(device=device).manual_seed(derive_seed(seed, "traffic.rows"))
    ids = torch.randint(traffic["vocab_first"], config["vocab_size"], (n, text_len),
                        generator=dev, device=device, dtype=torch.int32)
    pos = torch.arange(text_len, device=device)
    lengths = lengths.to(device)
    ids[:, 0] = traffic["cls_id"]
    ids = torch.where(pos == lengths[:, None] - 1, traffic["sep_id"], ids)
    ids = torch.where(pos < lengths[:, None], ids, traffic["pad_id"]).to(torch.int32)
    mask = (pos < lengths[:, None]).to(torch.float32)

    image_hw = image_hw.to(device)
    pixels = torch.randint(0, 256, (n, height, width, 3), generator=dev, device=device,
                           dtype=torch.uint8)
    inside = ((torch.arange(height, device=device)[None, :, None] < image_hw[:, :1, None])
              & (torch.arange(width, device=device)[None, None, :] < image_hw[:, 1:, None]))
    pixels *= inside[..., None].to(torch.uint8)
    rows = {
        "input_ids": ids,
        "text_mask": mask,
        "token_type_ids": torch.zeros_like(ids),
        "pixel_values": pixels,
        "patch_hw": (image_hw // patch).to(torch.int32),
        "labels": labels.to(device=device, dtype=torch.int32),
    }
    return [{k: v[i * batch:(i + 1) * batch].contiguous() for k, v in rows.items()}
            for i in range(n_batches)]
