"""Train state (counterpart of ``climb_tpu/train/train_state.py``): the
model's parameters, the AdamW moments beside them on the same device, and the
count of updates applied.

The parameters are the model's own ``nn.Parameter``s, updated in place. The
count is a host integer: the learning-rate schedule reads it without waiting
for the device. With the optimizer's ``skip_nonfinite = N`` guard
(``optax.apply_if_finite``), ``apply_gradients`` first checks the gradients
on the host: a non-finite step changes nothing but the guard's counters,
unless it is the (N+1)-th in a row.

On a mesh (``model.parallel``) the parameters are this rank's slices
(``parallel.sharding``), and so are the moments, the gradients and the
update; ``state_dict`` gathers whole tensors (every rank takes part) and
``load_state_dict`` takes whole tensors and keeps this rank's slices.
"""

from typing import Dict

import torch

from climb_tpu_torch.train.optimizer import AdamW


class TrainState:
    def __init__(self, params: Dict[str, torch.Tensor], tx: AdamW, parallel=None):
        self.params = params
        self.tx = tx
        self.parallel = parallel
        self.mu, self.nu = tx.init(params)
        self.step = 0  # updates applied: the optimizer's count
        self.notfinite_count = 0  # non-finite steps in a row
        self.total_notfinite = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: AdamW) -> "TrainState":
        return cls(dict(model.named_parameters()), tx, getattr(model, "parallel", None))

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One optimizer update; False when the guard skipped it."""
        if self.tx.skip_nonfinite:
            if self.parallel is None:
                finite = bool(torch.stack([torch.isfinite(g).all()
                                           for g in grads.values()]).all())
            else:
                finite = self.parallel.all_finite(grads.values())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and self.notfinite_count <= self.tx.skip_nonfinite:
                return False
        self.tx.step(self.params, grads, self.mu, self.nu, self.step)
        self.step += 1
        return True

    def _whole(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.parallel is None:
            return d
        return {n: self.parallel.full(n, t) for n, t in d.items()}

    def moments(self):
        """(mu, nu), on a mesh gathered whole from every rank's slices."""
        return self._whole(self.mu), self._whole(self.nu)

    def state_dict(self) -> dict:
        """Host copies of everything, for ``ckpt.checkpoint.save_train_state``
        (whole tensors; on a mesh every rank takes part)."""
        host = lambda d: {n: t.detach().to("cpu", copy=True) for n, t in d.items()}
        mu, nu = self.moments()
        return {"params": host(self._whole(self.params)), "mu": host(mu), "nu": host(nu),
                "step": self.step, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        """Restore from whole tensors (``state_dict``'s or a sharded
        checkpoint's); on a mesh each keeps this rank's slices."""
        for name in ("params", "mu", "nu"):
            own = getattr(self, name)
            if set(sd[name]) != set(own):
                raise ValueError(f"train state {name}: names differ from this model's")
            for n, t in own.items():
                src = sd[name][n]
                if self.parallel is not None:
                    src = self.parallel.localize({n: src})[n]
                t.copy_(src)
        self.step = int(sd["step"])
        self.notfinite_count = int(sd.get("notfinite_count", 0))
        self.total_notfinite = int(sd.get("total_notfinite", 0))
