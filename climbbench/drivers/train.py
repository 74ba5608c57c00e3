"""Train cells: the port's Phase I train step (forward, backward, AdamW) on
a pool of batches.

``correct`` follows the first steps. Set-up builds the learner, its
``TrainState`` and its step once, drives them through
``traffic["checked_steps"]`` steps on pool batches that all differ, and
hands that same state to the window. The reference trains a float32 copy of
the same weights on the same batches. The numbers:

- ``loss_gap``: the widest gap of a step's loss, over the reference's loss;
- ``grad_gap``: the worst parameter's gap between the norms of the first
  gradient (the program's worked out from AdamW's first moment after one
  update), over the reference's norm of that parameter or of the median
  parameter, whichever is larger;
- ``change_gap``: the same for the norm of each parameter's change over the
  checked steps, leaving out the trained parameters whose reference gradient
  is under a thousandth of the median's (they move by round-off alone);
- ``grad_error``: the worst parameter's norm of the difference between the
  two first gradients, over the same denominator as ``grad_gap``.

A limits file names the numbers a cell compares; the others are readings.
"""

import statistics

import torch

from climbbench import program
from climbbench.reference import model as ref
from climbbench.reference import train as ref_train
from climbbench.reference.params import frozen
from climbbench.weights import make_weights

NOUGHT = 1e-3  # a gradient under this share of the median parameter's moves by round-off


def leaf_gaps(got, want):
    """The loss gap, and for each other number each parameter's gap, of a
    record (losses, first gradient norms, change norms, first gradients)
    against the reference's record."""
    (loss, first, change, grads), (ref_loss, ref_first, ref_change, ref_grads) = got, want
    trained = [n for n in ref_first if not frozen(n)]
    median = statistics.median(ref_first[n] for n in trained)
    moving = [n for n in ref_first if frozen(n) or ref_first[n] >= NOUGHT * median]
    median_change = statistics.median(ref_change[n] for n in moving if not frozen(n))

    def each(a, b, names, floor):
        return {n: abs(a[n] - b[n]) / max(b[n], floor) for n in names}

    errors = ref_train.norms(grads[n].to(ref_grads[n].device) - ref_grads[n] for n in trained)
    return max(abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)), {
        "grad_gap": each(first, ref_first, ref_first, median),
        "change_gap": each(change, ref_change, moving, median_change),
        "grad_error": {n: e / max(ref_first[n], median) for n, e in zip(trained, errors)},
    }


def gaps(got, want):
    """The numbers: the loss gap and each other number's worst parameter."""
    loss, leaves = leaf_gaps(got, want)
    return {"loss_gap": loss, **{k: max(v.values()) for k, v in leaves.items()}}


def worst_leaves(got, want):
    """The parameter that sets each number but the loss gap."""
    return {k: max(v, key=v.get) for k, v in leaf_gaps(got, want)[1].items()}


class Driver:
    gaps = staticmethod(gaps)
    worst_leaves = staticmethod(worst_leaves)

    def __init__(self, run):
        self.run = run
        self.examples_per_step = run.traffic["batch"]
        self.losses = []
        self.want = None

    def setup(self):
        run = self.run
        self.model = program.learner(run.config, run.traffic, run.device, run.port)
        weights = make_weights(run.spec, run.seed, run.device)
        program.load_weights(self.model, weights)
        self.state, self.train = program.train_step(self.model, run.traffic)
        losses = []
        for i in range(run.traffic["checked_steps"]):
            losses.append(self.train(self.state, run.pool[i])["loss"])
            if i == 0:
                grads = program.first_gradients(self.state)
                first = dict(zip(grads, ref_train.norms(grads.values())))
                kept = {n: g.to("cpu") for n, g in grads.items() if not frozen(n)}
                del grads
        params = self.state.params
        change = dict(zip(weights, ref_train.norms(params[n].detach() - w
                                                    for n, w in weights.items())))
        del weights
        self.record = ([float(x) for x in losses], first, change, kept)
        self.offset = run.traffic["checked_steps"]
        for i in range(run.traffic["warmup_steps"]):
            self.step(i)
        self.offset += run.traffic["warmup_steps"]
        self.losses = []

    def step(self, i):
        pool = self.run.pool
        self.losses.append(self.train(self.state, pool[(self.offset + i) % len(pool)])["loss"])

    def failed(self):
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self):
        """Free the program's state before the reference runs."""
        del self.model, self.state, self.train
        self.losses = []

    def reference(self, arith=ref.F32):
        """The reference's record over the checked steps, computed by
        ``arith`` (the float32 one is kept)."""
        run = self.run
        if arith is ref.F32 and self.want is not None:
            return self.want
        ref.strict_f32()
        batches = run.pool[:run.traffic["checked_steps"]]
        record = ref_train.follow(run.config, run.traffic["task"],
                                  make_weights(run.spec, run.seed, run.device), batches,
                                  run.traffic["optimizer"], arith, keep_grads=True)
        if arith is ref.F32:
            self.want = record
        return record

    def judge(self):
        return gaps(self.record, self.reference())

    def stand_in(self, arith):
        """The numbers of the reference computed by ``arith`` in the
        program's place."""
        return gaps(self.reference(arith), self.reference())

    def control(self):
        """The numbers of the control: the reference in the precision below
        the configuration's in the program's place (the port has no
        lower-precision train step)."""
        return self.stand_in(ref.CONTROLS[self.run.config["port"]["compute_dtype"]])
