"""python -m raytracer_odin_tpu_torch.accuracy [cfg ...]
    [--part sameseed|proxy|draws|report|all] [--draws 16 --chunk 512
    --no-var-sweep] [--device cuda|cpu] [--out DIR] [--ref DIR]

Renders the named configs (all of configs.CONFIGS by default) on the card
(--device cpu renders on the CPU; without a card the default raises) and
writes their halves and report.jsonl into --out (configs.OUT_DIR). --part
all renders the same-seed and proxy halves of every config, fresh draws
of configs.DRAW_CONFIGS among them, then the report, and exits 1 if any
row fails same_seed_pass or distribution_agrees. --part draws extends
the draws already in --out (rendered by an earlier build, if the code
changed since).
"""

from __future__ import annotations

import argparse
import subprocess
import sys

PARTS = ("sameseed", "proxy", "draws", "report", "all")


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    import torch

    if torch.device(device).type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    from raytracer_odin_tpu_torch.accuracy import configs
    from raytracer_odin_tpu_torch.accuracy import render
    from raytracer_odin_tpu_torch.accuracy import report

    ap = argparse.ArgumentParser(
        prog="python -m raytracer_odin_tpu_torch.accuracy",
        description="The accuracy harness on the card: same-seed renders "
                    "against the JAX package's CPU renders, converged "
                    "renders against the numpy oracle.")
    ap.add_argument("configs", nargs="*",
                    help="config names (default: every config)")
    ap.add_argument("--part", choices=PARTS, default="all")
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--no-var-sweep", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help=f"output directory (default {configs.OUT_DIR})")
    ap.add_argument("--ref", default=None,
                    help=f"reference directory (default {configs.REF_DIR})")
    args = ap.parse_args(argv)

    rows = [configs.row(n) for n in args.configs] or list(configs.CONFIGS)
    names = [r[0] for r in rows]
    if args.part in ("report", "all"):
        configs.require_references(rows, args.ref)
    harness = render.Harness(args.device, args.out,
                             log=lambda s: print(s, flush=True))
    dev = device_line(harness.device)
    print(dev, flush=True)
    for name in names:
        if args.part in ("sameseed", "all"):
            harness.same_seed(name)
        if args.part in ("proxy", "all"):
            harness.proxy(name)
        if args.part == "draws" or (args.part == "all"
                                    and name in configs.DRAW_CONFIGS):
            harness.draws(name, args.draws, args.chunk,
                          var_sweep=not args.no_var_sweep,
                          resume=args.part == "draws")
    if args.part not in ("report", "all"):
        return 0
    records = report.report(harness.out, args.ref, rows, dev)
    bad = report.failures(records)
    for name, gate in bad:
        print(f"{name}: fails {gate}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
