"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python climbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The run makes its weights and a pool of batches from the seed on the card,
builds the cell's step through the port, takes it through its checked and
warm-up steps (set-up), then either dispatches steps back to back for
``--seconds`` (``--trace 0``: the end-to-end metrics) or runs a fixed
number of steps by the host clock and under the profiler (``--trace 1``:
the per-layer metrics). Then it frees the program, runs the reference and
compares. The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (steps), ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit, which also end standard error. Without the cards it exits
with 2 and prints no result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from climbbench.common import Manifest  # noqa: E402

# top-level module names no run may load: the JAX package and JAX itself
BANNED = ("jax", "jaxlib", "flax", "optax", "climb_tpu")
NAME_CHARS = 160  # device operation names are cut to this many characters in the breakdown


@dataclass
class Run:
    """What a driver is handed: one cell's configuration, traffic, seed and
    device, the parameter tree to draw, the pool of batches."""

    config: dict
    traffic: dict
    seed: int
    device: object
    spec: list
    pool: list = field(default_factory=list)
    port: dict = None  # port flags over the configuration's (tests, the control)


@dataclass
class Reading:
    """What the metric readers read."""

    config: dict
    traffic: dict
    examples_per_step: int
    setup_s: float = 0.0
    window: object = None  # measure.Window of the timed steps
    host: object = None  # measure.Window of the host-clock steps
    trace: object = None  # trace.Trace of the traced steps
    launches: dict = field(default_factory=dict)  # kernel calls in the traced steps


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="makes the weights and batches")
    p.add_argument("--seconds", type=float, required=True, help="length of the timed window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics from a traced run")
    return p.parse_args(argv)


def pin_caches():
    """Kernel and build caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "climbbench" / sub)


def power_limit_w():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def banned_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def span_hooks(module, name):
    """Forward hooks that open the profiler span ``name`` around each call of
    ``module``; returns their handles."""
    from torch.autograd.profiler import record_function

    opened = []

    def enter(mod, args):
        opened.append(record_function(name).__enter__())

    def leave(mod, args, out):
        opened.pop().__exit__(None, None, None)

    return [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]


def prepare(argv, device=None, overrides=None):
    """(args, cell, Run, driver, limits, manifest) of a run; ``device`` and
    ``overrides`` ({"config": ..., "traffic": ..., "port": ...}, merged
    over the files' top-level keys) serve the tests. Returns an exit code
    instead when the cards are missing."""
    args = parse(argv)
    pin_caches()
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    overrides = overrides or {}
    config = {**manifest.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**manifest.traffic(cell["traffic"]), **overrides.get("traffic", {})}
    limits = manifest.limits(cell["name"])
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"climbbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    from climbbench.reference.params import param_spec
    from climbbench.traffic import make_pool

    run = Run(config, traffic, args.seed, torch.device(device),
              param_spec(config, traffic["task"], traffic["labels"]), port=overrides.get("port"))
    run.pool = make_pool(traffic, config, args.seed, run.device)
    driver = manifest.driver(traffic["kind"]).Driver(run)
    return args, cell, run, driver, limits, manifest


def main(argv=None, device=None, overrides=None):
    prepared = prepare(argv, device, overrides)
    if isinstance(prepared, int):
        return prepared
    args, cell, run, driver, limits, manifest = prepared
    import torch

    from climbbench import measure, program

    cuda = run.device.type == "cuda"
    clock = measure.Clock(run.device)
    driver.setup()
    clock.sync()
    reading = Reading(run.config, run.traffic, driver.examples_per_step,
                      setup_s=time.perf_counter() - START)
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    if args.trace:
        steps = run.traffic["trace_steps"]
        reading.host = measure.host_window(driver.step, steps, 0, clock)
        bert = program.text_encoder(driver.model)
        hooks = span_hooks(bert, "bench.bert") if bert is not None else []
        reading.trace, reading.launches = measure.traced_window(
            driver.step, steps, steps, clock, program.launches)
        for hook in hooks:
            hook.remove()
        attempted = 2 * steps + measure.PROFILER_WARM_STEPS
    else:
        reading.window = measure.timed_window(driver.step, args.seconds, clock)
        attempted = reading.window.steps
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    failed = driver.failed()
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = {name: {"value": value, "limit": limits[name]["limit"]}
              for name, value in driver.judge().items() if name in limits}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    metrics = {}
    for entry in manifest.metrics(cell["name"], args.trace):
        value = manifest.reader(entry["name"]).read(reading)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev.update(busy_s=reading.trace.busy_s, window_s=reading.trace.window_s)
        breakdown = reading.trace.breakdown()
        result["breakdown"] = {k: [[name[:NAME_CHARS], s] for name, s in rows]
                               for k, rows in breakdown.items()}
    result["checks"] = checks
    banned = banned_modules()
    if banned:
        print(f"climbbench: the run loaded {banned}, which no run may load", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
