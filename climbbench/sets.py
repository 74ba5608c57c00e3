"""Sets of runs of one cell, and the spreads the bounds are set from. Not
part of a benchmark run.

    python climbbench/sets.py --workload <cell> --seeds 1,2,3 --sets 2 --seconds 51 --out runs.jsonl
    python climbbench/sets.py --summary runs.jsonl

The first form runs ``climbbench/run.py`` once for each seed in each set,
every set over the same seeds, one process at a time, and appends one JSON
line a run to ``--out``: the cell, set, seed, exit code, wall seconds and
the run's result line (the end of standard error too where the run failed).
The second prints, for each cell, metric and set, the median, the quartile
spread (the distance between the first and third quartile, as
``statistics.quantiles(values, n=4)`` gives them, over the median), the same
with the run farthest from the median left out, and five times the widest
spread of each metric, the bound it suggests (never under 1%).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ERR_CHARS = 4000
FLOOR = 0.01


def run_sets(args):
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for s in range(args.sets):
        for seed in args.seeds.split(","):
            start = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "climbbench" / "run.py"), "--workload", args.workload,
                 "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            row = {"cell": args.workload, "set": s, "seed": int(seed), "trace": args.trace,
                   "rc": proc.returncode, "wall": time.perf_counter() - start,
                   "result": json.loads(lines[-1]) if proc.returncode == 0 and lines else None}
            if row["result"] is None or not row["result"]["correct"]:
                row["stderr"] = proc.stderr[-ERR_CHARS:]
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps({k: row[k] for k in ("cell", "set", "seed", "rc", "wall")}),
                  flush=True)


def spread(values):
    """The quartile spread over the median."""
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def summary(paths):
    rows = [json.loads(line) for p in paths for line in open(p) if line.strip()]
    cells = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for r in rows:
        res = r["result"]
        tag = f"{r['cell']} trace={r.get('trace', 0)}"
        if res is None:
            print(f"{tag} set {r['set']} seed {r['seed']}: rc {r['rc']}, no result")
            continue
        if not res["correct"]:
            print(f"{tag} set {r['set']} seed {r['seed']}: not correct {res.get('checks')}")
        for name, m in res["metrics"].items():
            cells[tag][name][r["set"]].append(m["value"])
    widest = defaultdict(float)
    for tag, metrics in sorted(cells.items()):
        n_ok = sum(1 for r in rows if r["result"] and r["result"]["correct"]
                   and f"{r['cell']} trace={r.get('trace', 0)}" == tag)
        print(f"{tag}: {n_ok} runs correct")
        for name, sets in sorted(metrics.items()):
            parts = []
            for s, values in sorted(sets.items()):
                sp = spread(values)
                cut = spread(trimmed(values)) if len(values) > 2 else sp
                parts.append(f"set {s} median {statistics.median(values)!r} spread {sp:.4%} "
                             f"trimmed {cut:.4%} n {len(values)}")
                if not tag.endswith("trace=1"):
                    widest[name] = max(widest[name], sp)
            print(f"  {name}: " + "; ".join(parts))
    for name, sp in sorted(widest.items()):
        print(f"bound {name}: widest spread {sp:.4%}, 5x {max(5 * sp, FLOOR):.4f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", help="comma-separated")
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", help="JSON lines file the runs are appended to")
    p.add_argument("--summary", nargs="*", help="JSON lines files to summarise")
    args = p.parse_args(argv)
    if args.summary:
        summary(args.summary)
    elif args.workload and args.seeds and args.out:
        run_sets(args)
    else:
        p.error("give --workload, --seeds and --out, or --summary")
    return 0


if __name__ == "__main__":
    sys.exit(main())
