"""Short-schedule A/B of distillation recipe knobs on one family.

Before spending device-hours on full 12k-step runs for all three distilled
families, this runs a short (default 3000-step) multi-resolution schedule
for each candidate knob setting on ONE family and reports the best
held-out min(precision, recall) checkpoint per arm — the selection metric
distill(select_best=True) uses. Pick the winner, then run
tools/distill_families.py with those knobs.

Run: python tools/distill_ab.py [--prefix sp_sparse] [--steps 3000]
Writes docs/distill_ab_<prefix>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spsvo  # noqa: E402  (pins matmul precision, XLA cache)
from spsvo import distill as D  # noqa: E402

ARMS = {
    # round-3 shipped recipe (peak_weight 4, no clean samples, T=1)
    "baseline": {},
    # validation-distribution training: 25% clean crops
    "clean25": {"clean_prob": 0.25},
    # stronger peak emphasis
    "peak8": {"peak_weight": 8.0},
    # classic KD softening
    "temp2": {"temperature": 2.0},
    # combined front-runner
    "clean25_peak8": {"clean_prob": 0.25, "peak_weight": 8.0},
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="sp_sparse",
                    help="family to A/B on (default: the weakest student)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated subset of arms to run")
    args = ap.parse_args()

    docs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs")
    out_path = os.path.join(docs, f"distill_ab_{args.prefix}.json")
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    for arm in args.arms.split(","):
        knobs = ARMS[arm]
        print(f"=== arm {arm}: {knobs} ===", flush=True)
        _, hist = D.distill(args.prefix, steps=args.steps,
                            resolutions=D.DEFAULT_RESOLUTIONS,
                            ema=0.999, select_best=True, **knobs)
        vrows = [r for r in hist if "precision" in r]
        results[arm] = {
            "knobs": knobs, "steps": args.steps,
            "best_step": hist[-1].get("best_step"),
            "best_min_pr": hist[-1].get("best_score"),
            "final_precision": vrows[-1]["precision"],
            "final_recall": vrows[-1]["recall"],
            "history": vrows}
        print(f"{arm}: best min(P,R) {results[arm]['best_min_pr']:.3f} "
              f"@ step {results[arm]['best_step']}", flush=True)
        with open(out_path, "w") as f:   # checkpoint after every arm
            json.dump(results, f, indent=1)

    ranked = sorted(results, key=lambda a: -(results[a]["best_min_pr"] or 0))
    print("ranking:", [(a, round(results[a]["best_min_pr"], 3))
                       for a in ranked])
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
