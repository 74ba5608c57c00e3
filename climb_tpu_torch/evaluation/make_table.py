"""Aggregate Phase II results into mean±std tables (the port's copy of
``climb_tpu/evaluation/make_table.py``; the port's results JSONs are the JAX
package's, field for field).

Parity: reference ``src/utils/make_table.py`` — merges
``{task}_{upstream}_results.json`` files into nested
``{backbone}{algo}{task_order}{task_name}{n_shot} -> 'mean ±std'`` tables
(vision tasks report the single seed's test score). Paths are parameterized
instead of the reference's hardcoded /data locations.

Usage: python -m climb_tpu_torch.evaluation.make_table <task_name> --results_root DIR
"""

import argparse
import glob
import json
import os
import pprint
from collections import defaultdict

import numpy as np

VISION_TASKS = ["coco", "imagenet", "inat2019", "places365"]


def merge_all_results(all_scores, fns, backbone, is_vision=False):
    for fn in fns:
        with open(fn) as f:
            rdict = json.load(f)

        name = os.path.basename(fn).split("_")[:-1]
        if len(name) == 2:
            algo, t_order, t_name = backbone, "task0", "NA"
        elif len(name) == 3:
            algo = "single"
            t_order, t_name = name[1:]
        else:
            t_order, t_name, algo = name[1:4]

        for k in rdict.keys():
            scores = np.array([list(v) for v in rdict[k].values()], dtype=float)
            test_scores = scores[:, 0]
            n_shot = k.split("-")[-1]
            if is_vision:
                all_scores[algo][t_order][t_name][n_shot] = f"{test_scores[0]:.1f}"
            else:
                all_scores[backbone][algo][t_order][t_name][n_shot] = (
                    f"{test_scores.mean():.1f} ±{test_scores.std():.1f}"
                )
    return all_scores


def dump_outputs(all_scores, task_name, out_dir="."):
    out_fn = os.path.join(out_dir, f"{task_name}.json")
    with open(out_fn, "w") as f:
        f.write(json.dumps(all_scores))
    with open(out_fn) as f:
        pprint.PrettyPrinter().pprint(json.load(f))
    return out_fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("task_name")
    parser.add_argument("--results_root", default=".",
                        help="Directory holding {lang_only,vision_only} result dirs.")
    parser.add_argument("--out_dir", default=".")
    args = parser.parse_args(argv)

    tree = lambda: defaultdict(tree)  # noqa: E731
    all_scores = tree()
    if args.task_name in VISION_TASKS:
        fns = glob.glob(os.path.join(args.results_root, "vision_only", f"{args.task_name}_*"))
        all_scores = merge_all_results(all_scores, fns, "ViLT", is_vision=True)
    else:
        fns = glob.glob(os.path.join(args.results_root, "lang_only", f"{args.task_name}_*"))
        all_scores = merge_all_results(all_scores, fns, "ViLT")
        fns = glob.glob(
            os.path.join(args.results_root, "lang_only", "viltbert", f"{args.task_name}_*")
        )
        all_scores = merge_all_results(all_scores, fns, "ViLTBERT")
    return dump_outputs(all_scores, args.task_name, args.out_dir)


if __name__ == "__main__":
    main()
