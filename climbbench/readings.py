"""The readings that the limits of ``correct`` are set from, many seeds in
one process: for each seed the numbers of a sound run of the program (its
set-up, ``--steps`` steps, the same comparison as ``run.py``), of the
control (the lower precision in the program's place) and of the faults a
cell can have, planted in the reference put in the program's place.

    python climbbench/readings.py --workload <cell> --seeds 1,2,3 [--steps 16] [--control 1]
        [--faults 1] [--stand_ins fp8,bf16_emulated] [--int8 1] [--leaves 1]

One JSON line a seed on standard output. Not part of a benchmark run.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from climbbench import run as bench  # noqa: E402
from climbbench.reference import model as ref  # noqa: E402
from climbbench.reference import train as ref_train  # noqa: E402
from climbbench.weights import make_weights  # noqa: E402


# ways to compute the reference in the program's place (``--stand_ins``)
STAND_INS = {"fp8": ref.FP8, "tf32": ref.TF32_PRODUCTS, "bf16_emulated": ref.BF16_EMULATED}


def half_batch(batch):
    """The batch's first half: the fault that leaves half of it out."""
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def fault_readings(driver):
    """The numbers of each fault a cell can have, planted in the float32
    reference put in the program's place."""
    r = driver.run
    weights = make_weights(r.spec, r.seed, r.device)
    want = driver.reference()
    if r.traffic["kind"] == "train":
        batches = [half_batch(b) for b in r.pool[:r.traffic["checked_steps"]]]
        half = ref_train.follow(r.config, r.traffic["task"], weights, batches,
                                r.traffic["optimizer"], keep_grads=True)
        return {"half_batch": driver.gaps(half, want)}
    with torch.no_grad():
        half = torch.stack([ref.logits(ref.F32, weights, r.config, r.traffic["task"],
                                       half_batch(b)) for b in r.pool])
    altered = want.clone()
    altered[:, 0] = altered[:, 0].roll(1, dims=-1)
    return {"half_batch": driver.gaps(torch.cat([half, half], dim=1)[:, :want.shape[1]], want),
            "answer_altered": driver.gaps(altered, want)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--steps", type=int, default=16, help="steps after set-up (eval)")
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--int8", type=int, default=0,
                   help="eval cells: the port's int8 dense forward in the program's place")
    p.add_argument("--leaves", type=int, default=0,
                   help="train cells: the parameter that sets each number")
    p.add_argument("--stand_ins", default="",
                   help="comma-separated: the reference in the program's place, computed as "
                        + ", ".join(STAND_INS))
    args = p.parse_args(argv)
    for seed in args.seeds.split(","):
        argv_run = ["--workload", args.workload, "--seed", seed, "--seconds", "0"]
        prepared = bench.prepare(argv_run)
        if isinstance(prepared, int):
            return prepared
        driver = prepared[3]
        row = {"seed": int(seed)}
        driver.setup()
        for i in range(args.steps):
            driver.step(i)
        driver.release()
        gc.collect()
        torch.cuda.empty_cache()
        row["program"] = driver.judge()
        leaves = args.leaves and hasattr(driver, "worst_leaves")
        if leaves:
            row["program_leaves"] = driver.worst_leaves(driver.record, driver.reference())
        if args.control:
            row["control"] = driver.control()
        for name in filter(None, args.stand_ins.split(",")):
            row[name] = driver.stand_in(STAND_INS[name])
            if leaves:
                row[name + "_leaves"] = driver.worst_leaves(driver.reference(STAND_INS[name]),
                                                            driver.reference())
        if args.int8 and hasattr(driver, "int8"):
            row["int8_port"] = driver.int8(args.steps)
        if args.faults:
            row["faults"] = fault_readings(driver)
        print(json.dumps(row), flush=True)
        del driver, prepared
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
