"""Plain float32 ViLT-B/32, BERT-base, CLiMB's classification head, its loss
and AdamW: the yardstick that decides a run's ``correct``.

A frozen copy of the published equations (HF ``ViltModel`` and ``BertModel``,
CLiMB's ``ViltContinualLearner`` head and ``AdamW``). It imports torch alone
and takes from the benchmark only the weights and batches the benchmark made
from the seed. Every product and every tensor the port keeps in its compute
dtype goes through an ``Arith``: ``F32`` rounds nowhere (float32 with TF32
off, ``strict_f32``). The controls round every operand of every product to
the precision below the configuration's: ``TF32_PRODUCTS`` under float32,
``FP8`` (e4m3, gradients e5m2, one scale a tensor) under bfloat16.
``BF16_EMULATED`` rounds where the port's bf16 path rounds, a witness of how
far bf16 alone takes the result.

Departures from the published equations:
- Images lie on a fixed canvas and every patch of the valid top-left region
  is kept, the rest masked (CLiMB's collation), where HF's ``ViltEmbeddings``
  samples at most ``max_image_length`` patches. The position grid is
  resampled per image to its valid (rows, columns) as HF does (bilinear,
  align_corners) and padded with zeros.
- The patch projection is a (D, p*p*C) matrix over patches flattened in
  (row, column, channel) order: HF's Conv2d weight (D, C, p, p) under a
  permutation, in the layout of the parameter tree the benchmark draws.
- The image is normalized as the configuration's compute dtype rounds it
  (JAX's ``normalize_images``): in bfloat16, 1/255, the product and the
  difference from the mean are each rounded to bfloat16, where the
  published ``(u/255 - 0.5)/0.5`` rounds once. u/255 rounds up there (to
  (u+1)/256 for u >= 128), a bias of up to 2^-8 a pixel that every bf16
  run of the port carries and the reference now carries too.
- BERT's output replaces ViLT's word embeddings in ViLT-BERT (CLiMB's
  ``ViltBertModel``); ViLT's token-type and position embeddings and its text
  LayerNorm still apply. BERT is frozen: it runs without autograd.
"""

import math

import torch
import torch.nn.functional as F


TF32 = "tf32"


def strict_f32():
    """float32 products really in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x, fmt):
    """``x`` rounded to the format ``fmt`` and back to float32: a torch
    dtype, or ``TF32`` (float32 with a 10-bit mantissa, to nearest even, as
    the tensor cores read float32 operands under TF32). float8 takes one
    scale a tensor, its largest magnitude at the format's largest value."""
    if fmt == TF32:
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if fmt.itemsize > 1:
        return x.to(fmt).to(torch.float32)
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(torch.float32) * scale


class _Round(torch.autograd.Function):
    """Rounds the value to one format and its gradient to another."""

    @staticmethod
    def forward(ctx, x, forward_dtype, backward_dtype):
        ctx.backward_dtype = backward_dtype
        return _round(x, forward_dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.backward_dtype), None, None


class Arith:
    """Where the computation rounds. ``operand``: (forward, backward)
    formats of every operand of a product and of its gradient; ``store``:
    those of the tensors the port keeps in its compute dtype (block inputs
    and outputs, normalized rows, products' outputs). None keeps float32;
    sums are always float32."""

    def __init__(self, operand=None, store=None):
        self.operand, self.store = operand, store

    def op(self, x):
        return x if self.operand is None else _Round.apply(x, *self.operand)

    def st(self, x):
        return x if self.store is None else _Round.apply(x, *self.store)

    def matmul(self, a, b):
        return self.st(torch.matmul(self.op(a), self.op(b)))

    def linear(self, x, w, b):
        return self.st(torch.matmul(self.op(x), self.op(w).t()) + b)


F8 = (torch.float8_e4m3fn, torch.float8_e5m2)
BF16 = (torch.bfloat16, torch.bfloat16)
F32 = Arith()
# the controls, the nearest precision below the configuration's: every
# product's operands in float8 (e4m3, gradients e5m2) under bfloat16, in
# TF32 under float32
FP8 = Arith(operand=F8)
TF32_PRODUCTS = Arith(operand=(TF32, TF32))
CONTROLS = {"bfloat16": FP8, "float32": TF32_PRODUCTS}
# a witness: the port's bf16 roundings emulated in the reference's equations
BF16_EMULATED = Arith(operand=BF16, store=BF16)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def mask_bias(mask):
    """(B, S) {0, 1} -> (B, 1, 1, S) additive bias (HF's extended mask)."""
    return ((1.0 - mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]


def attention(ar, x, p, pre, names, heads, bias):
    """Multi-head self-attention: softmax(Q K^T / sqrt(d) + bias) V, then the
    output projection."""
    b, s, d = x.shape
    dh = d // heads
    q, k, v = (ar.linear(x, p[pre + n + ".weight"], p[pre + n + ".bias"])
               .view(b, s, heads, dh).transpose(1, 2) for n in names[:3])
    scores = torch.matmul(ar.op(q), ar.op(k.transpose(-1, -2))) / math.sqrt(dh) + bias
    ctx = ar.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, s, d)
    return ar.linear(ctx, p[pre + names[3] + ".weight"], p[pre + names[3] + ".bias"])


def ffn(ar, x, p, pre):
    h = ar.st(F.gelu(ar.linear(x, p[pre + "fc1.weight"], p[pre + "fc1.bias"])))
    return ar.linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])


def patch_positions(grid, patch_hw, grid_h, grid_w):
    """(n, n, D) position grid -> (B, grid_h * grid_w, D): per image bilinear
    (align_corners) to its valid rows and columns, zero elsewhere."""
    out = grid.new_zeros(patch_hw.shape[0], grid_h, grid_w, grid.shape[-1])
    src = grid.permute(2, 0, 1)[None]
    for h, w in {tuple(hw) for hw in patch_hw.tolist()}:
        pos = F.interpolate(src, size=(h, w), mode="bilinear", align_corners=True)
        rows = ((patch_hw[:, 0] == h) & (patch_hw[:, 1] == w)).nonzero()[:, 0]
        out[rows, :h, :w] = pos[0].permute(1, 2, 0)
    return out.reshape(patch_hw.shape[0], grid_h * grid_w, -1)


def normalize(pixels, dtype):
    """uint8 pixels -> ViltImageProcessor's rescale by 1/255, then mean 0.5
    and std 0.5, rounded as the configuration's compute dtype rounds them:
    1/255 rounded to ``dtype``, the product and the difference each rounded
    to ``dtype`` (JAX's ``normalize_images``, the port's spec). The result
    is exact in float32."""
    dtype = getattr(torch, dtype)
    inv255 = torch.tensor(1.0 / 255.0, dtype=dtype).float()
    x = (pixels.float() * inv255).to(dtype).float()
    return (x - 0.5).to(dtype).float() / 0.5


def vilt_pooled(ar, p, pre, cfg, batch, text_embeds=None):
    """ViLT's pooled output (B, D) for a batch of token ids, text mask, uint8
    canvas (B, H, W, C) and valid patch grid (B, 2)."""
    d, ps, eps = cfg["hidden_size"], cfg["patch_size"], cfg["layer_norm_eps"]
    ids, mask = batch["input_ids"].long(), batch["text_mask"].float()
    b, length = ids.shape
    if text_embeds is None:
        text_embeds = p[pre + "word_embeddings.weight"][ids]
    types = batch["token_type_ids"].long()
    t = (text_embeds + p[pre + "token_type_embeddings.weight"][types]
         + p[pre + "text_position_embeddings"][:length])
    t = layer_norm(t, p, pre + "text_layernorm", eps)

    pix = normalize(batch["pixel_values"], cfg["port"]["compute_dtype"])
    _, hh, ww, c = pix.shape
    gh, gw = hh // ps, ww // ps
    patches = (pix.reshape(b, gh, ps, gw, ps, c).permute(0, 1, 3, 2, 4, 5)
               .reshape(b, gh * gw, ps * ps * c))
    proj = ar.linear(patches, p[pre + "patch_projection.weight"],
                     p[pre + "patch_projection.bias"])
    vis_pos = p[pre + "visual_position_embeddings"]
    n = int(round(math.sqrt(vis_pos.shape[0] - 1)))
    patch_hw = batch["patch_hw"].long()
    pos = patch_positions(vis_pos[1:].reshape(n, n, d), patch_hw, gh, gw)
    cls = (p[pre + "cls_token"].reshape(1, 1, d) + vis_pos[0]).expand(b, 1, d)
    img = torch.cat([cls, proj + pos], dim=1)
    rows = torch.arange(gh, device=ids.device)[None, :, None] < patch_hw[:, 0, None, None]
    cols = torch.arange(gw, device=ids.device)[None, None, :] < patch_hw[:, 1, None, None]
    img_mask = torch.cat([torch.ones(b, 1, device=ids.device),
                          (rows & cols).reshape(b, gh * gw).float()], dim=1)

    modality = p[pre + "modality_type_embeddings.weight"]
    x = ar.st(torch.cat([t + modality[0], img + modality[1]], dim=1))
    bias = mask_bias(torch.cat([mask, img_mask], dim=1))
    heads = cfg["num_attention_heads"]
    for i in range(cfg["num_hidden_layers"]):
        blk = f"{pre}encoder.{i}."
        x = ar.st(x + attention(ar, ar.st(layer_norm(x, p, blk + "ln1", eps)), p, blk,
                                ("q", "k", "v", "attn_out"), heads, bias))
        x = ar.st(x + ffn(ar, ar.st(layer_norm(x, p, blk + "ln2", eps)), p, blk))
    x = ar.st(layer_norm(x, p, pre + "final_layernorm", eps))
    return ar.st(torch.tanh(ar.linear(x[:, 0], p[pre + "pooler.weight"],
                                      p[pre + "pooler.bias"])))


def bert_hidden(ar, p, pre, cfg, batch):
    """BERT's last hidden state (B, L, D): post-norm layers over the summed,
    normalized word, position and token-type embeddings."""
    eps = cfg["layer_norm_eps"]
    ids = batch["input_ids"].long()
    length = ids.shape[1]
    x = (p[pre + "word_embeddings.weight"][ids] + p[pre + "position_embeddings.weight"][:length]
         + p[pre + "token_type_embeddings.weight"][batch["token_type_ids"].long()])
    x = ar.st(layer_norm(x, p, pre + "embed_layernorm", eps))
    bias = mask_bias(batch["text_mask"])
    for i in range(cfg["num_hidden_layers"]):
        blk = f"{pre}encoder.{i}."
        x = ar.st(layer_norm(x + attention(ar, x, p, blk, ("q", "k", "v", "attn_out"),
                                           cfg["num_attention_heads"], bias),
                             p, blk + "attn_ln", eps))
        x = ar.st(layer_norm(x + ffn(ar, x, p, blk), p, blk + "mlp_ln", eps))
    return x


def head_logits(ar, p, pre, pooled):
    """CLiMB's classification head: Linear(D, 2D) -> LayerNorm(eps 1e-5) ->
    GELU -> Linear(2D, labels)."""
    h = ar.linear(pooled, p[pre + "fc1.weight"], p[pre + "fc1.bias"])
    h = ar.st(F.gelu(ar.st(layer_norm(h, p, pre + "ln", 1e-5))))
    return ar.linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])


def logits(ar, p, config, task, batch):
    """The task's logits for ``batch`` under the parameters ``p`` (names as
    ``params.param_spec`` gives them)."""
    if config["model"] == "viltbert":
        with torch.no_grad():
            text = bert_hidden(ar, p, "viltbert.bert.", config["bert"], batch)
        pooled = vilt_pooled(ar, p, "viltbert.vilt.", config, batch, text_embeds=text)
    else:
        pooled = vilt_pooled(ar, p, "vilt.", config, batch)
    return head_logits(ar, p, "head_" + task.replace("-", "_") + ".", pooled)


def loss(ar, p, config, task, batch):
    """Mean cross-entropy over the batch."""
    out = logits(ar, p, config, task, batch)
    return F.cross_entropy(out, batch["labels"].long())
