"""The reference's training steps: float32 forward and backward (autograd
over ``model.loss``), then AdamW as CLiMB configures it (HF/optax
``adamw``: betas (0.9, 0.98), bias-corrected moments, eps outside the
square root, decoupled weight decay added to the update before the learning
rate, linear warmup then linear decay to 0, frozen parameters never moved).
"""

import torch

from climbbench.reference import model, params as tree


def norms(tensors):
    """Each tensor's 2-norm, as floats."""
    return torch.stack(torch._foreach_norm(list(tensors))).tolist()


def learning_rate(opt, step):
    """The rate of update ``step`` (0-based): linear warmup over
    int(total * warmup_ratio) steps, then linear decay to 0."""
    total, warm = opt["total_steps"], int(opt["total_steps"] * opt["warmup_ratio"])
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    return opt["lr"] * min(max(1.0 - (step - warm) / max(total - warm, 1), 0.0), 1.0)


def adamw(p, g, mu, nu, step, opt, decays):
    """One AdamW update of parameter ``p`` by gradient ``g`` (``mu`` and
    ``nu`` updated in place); returns the new parameter."""
    b1, b2, t = 0.9, 0.98, step + 1
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    upd = (mu / (1 - b1 ** t)) / ((nu / (1 - b2 ** t)).sqrt() + opt["adam_epsilon"])
    if decays:
        upd = upd + opt["weight_decay"] * p
    return p - learning_rate(opt, step) * upd


def follow(config, task, weights, batches, opt, ar=model.F32, keep_grads=False):
    """Train a float32 copy of ``weights`` on ``batches``, one step each.
    Returns (each step's loss, each parameter's first gradient norm, each
    parameter's change norm after the last step, and with ``keep_grads`` the
    trained parameters' first gradients, else None)."""
    p = {n: w.detach().clone() for n, w in weights.items()}
    trained = [n for n in p if not tree.frozen(n)]
    mu = {n: torch.zeros_like(p[n]) for n in trained}
    nu = {n: torch.zeros_like(p[n]) for n in trained}
    losses, first, kept = [], None, None
    for step, batch in enumerate(batches):
        leaves = [p[n].requires_grad_(True) for n in trained]
        loss = model.loss(ar, p, config, task, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
            if first is None:
                first = dict(zip(trained, norms(grads)))
                first.update({n: 0.0 for n in p if tree.frozen(n)})
                kept = dict(zip(trained, grads)) if keep_grads else None
            for n, g in zip(trained, grads):
                p[n] = adamw(p[n].detach(), g, mu[n], nu[n], step, opt, tree.decays(n))
            del grads
    with torch.no_grad():
        change = dict(zip(weights, norms([p[n].detach() - w for n, w in weights.items()])))
    return losses, first, change, kept
