"""The readings that the limit of ``correct`` is set from, on the card.

    python3 cardbench/control.py --workload <name> --seeds <n> [<n> ...] \\
        --seconds <s> [--control-seeds <k>]

runs the cell once a seed, in one process, through the same set-up,
window and comparison as ``run.py``, and prints a JSON line a seed: the
program's worst relative error (``program``) and its ``correct`` and, on
the first ``k`` seeds, the control's: the float64 reference computed on
inputs rounded to TF32, put in the program's place and judged by the same
checks on the same outputs (``control``, ``control_correct``, which has to
be false).  The last line gives the lower reading (the program's largest),
the upper (the control's smallest), the configuration's limit between
them, and whether every program run came out correct and every control
run not.  The benchmark's own runs never run the control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from cardbench.core import manifest, verdict
    from cardbench.core.cell import run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load(ROOT)
    cfg = bench.config(bench.cell(args.workload)["config"])
    program, control, verdicts = [], [], []
    for i, seed in enumerate(args.seeds):
        result, checks, ctl = run_cell(
            bench, args.workload, seed, args.seconds, False, device="cuda:0",
            t_process=time.perf_counter(), control=i < args.control_seeds,
            log=lambda line: print(line, file=sys.stderr, flush=True))
        p = checks.items["worst_rel_err"]["value"]
        program.append(p)
        verdicts.append(result["correct"])
        line = {"workload": args.workload, "seed": seed, "program": p,
                "correct": result["correct"], "attempted": result["attempted"]}
        if ctl is not None:
            control.append(ctl.items["worst_rel_err"]["value"])
            verdicts.append(not ctl.correct)
            line["control"] = control[-1]
            line["control_correct"] = ctl.correct
            for text in ctl.lines():
                print("control " + text, file=sys.stderr, flush=True)
        print(json.dumps(line), flush=True)
        del result, checks, ctl
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": max(program),
                      "upper": min(control) if control else None,
                      "limit": verdict.limit(cfg), "seeds": len(program),
                      "control_seeds": len(control),
                      "program_correct_control_not": all(verdicts)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
