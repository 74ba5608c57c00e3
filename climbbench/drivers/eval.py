"""Eval cells: the port's eval step (the forward ``predict`` and every
trainer's eval epoch run) on a pool of batches, the logits left on the card.

``correct`` judges every answer of the window: each step's logits against
the float32 reference's logits of the same pool batch, under the same
weights. Two numbers are compared, each over the root mean square of the
reference's logits: ``logit_gap``, the widest gap of a logit, and
``logit_rms_gap``, the root mean square gap.
"""

import torch

from climbbench import program
from climbbench.reference import model as ref
from climbbench.weights import make_weights

class Driver:
    def __init__(self, run):
        self.run = run
        self.examples_per_step = run.traffic["batch"]
        self.outputs = []
        self.want = None

    def setup(self):
        run = self.run
        self.model = program.learner(run.config, run.traffic, run.device, run.port)
        program.load_weights(self.model, make_weights(run.spec, run.seed, run.device))
        self.eval = program.eval_step(self.model, run.traffic)
        for i in range(run.traffic["warmup_steps"]):
            self.eval(run.pool[i % len(run.pool)])
        self.outputs = []

    def step(self, i):
        pool = self.run.pool
        self.outputs.append((i % len(pool), self.eval(pool[i % len(pool)])[0]))

    def failed(self):
        if not self.outputs:
            return 0
        finite = torch.stack([torch.isfinite(out).all() for _, out in self.outputs])
        return int((~finite).sum())

    def release(self):
        del self.model, self.eval

    def reference(self, arith=ref.F32):
        """The logits of every pool batch, (pool, batch, labels), computed
        by ``arith`` (the float32 ones are kept)."""
        run = self.run
        if arith is ref.F32 and self.want is not None:
            return self.want
        ref.strict_f32()
        weights = make_weights(run.spec, run.seed, run.device)
        with torch.no_grad():
            logits = torch.stack([ref.logits(arith, weights, run.config, run.traffic["task"], b)
                                  for b in run.pool])
        if arith is ref.F32:
            self.want = logits
        return logits

    @staticmethod
    def gaps(got, want):
        """The numbers of answers ``got`` against the reference's ``want``,
        each over the root mean square of ``want``."""
        scale = want.square().mean().sqrt()
        diff = got.float() - want
        return {"logit_gap": float(diff.abs().amax() / scale),
                "logit_rms_gap": float(diff.square().mean().sqrt() / scale)}

    def judge(self):
        want = self.reference()
        which = torch.tensor([i for i, _ in self.outputs], device=want.device)
        got = torch.stack([out for _, out in self.outputs])
        return self.gaps(got, want[which])

    def int8(self, steps):
        """The numbers of the port's int8 dense forward (``--dense_impl
        int8``) over ``steps`` steps, read beside the control."""
        self.run.port = {**(self.run.port or {}), "dense_impl": "int8"}
        self.setup()
        for i in range(steps):
            self.step(i)
        self.release()
        return self.judge()

    def stand_in(self, arith):
        """The numbers of the reference computed by ``arith`` in the
        program's place."""
        return self.gaps(self.reference(arith), self.reference())

    def control(self):
        """The numbers of the control: the reference in the precision below
        the configuration's in the program's place. The port's int8 dense
        forward is not the control: its logits lie within the spread of
        sound bf16 runs over seeds."""
        return self.stand_in(ref.CONTROLS[self.run.config["port"]["compute_dtype"]])
