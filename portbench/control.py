"""The control and the faults at a cell's own size, on several seeds, for
setting the limit of `correct` (the benchmark's own runs never run it):

    python3 portbench/control.py --workload h15-prove --seeds 11,12,13 \
        --seconds 3 [--break other_leaves,answer_altered]

For each seed it runs the cell once as it is and once with each hook of
`faults.py` named by --break, and prints a line of the numbers compared
(and the window's proofs) for each run. The program's sound runs give the
lower readings, the broken ones the upper."""

import time

T_START = time.monotonic()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv, root):
    import argparse
    from portbench import faults, harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--break", dest="breaks", default="other_leaves")
    ap.add_argument("--sound", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    kinds = ([None] if args.sound else []) + [
        b for b in args.breaks.split(",") if b]
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind in kinds:
            t0 = time.monotonic()
            line, run, verdict = harness.run_cell(
                root, args.workload, seed, args.seconds, False, t0,
                hook=faults.HOOKS[kind] if kind else None)
            print(json.dumps({
                "control": kind or "sound", "workload": args.workload,
                "seed": seed, "correct": line["correct"],
                "compared": line["compared"],
                "attempted": line["attempted"], "failed": line["failed"],
                "reasons": verdict["reasons"],
                "reference_s": verdict["seconds"],
                "run_s": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:], ROOT))
