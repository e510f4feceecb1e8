"""Readings that the correctness limits are set from, on the card at a
cell's own size: for each seed, the window a run makes, then the compared
numbers of the program's outputs and of the control's (the reference in
TF32 put in the program's place). Not part of a benchmark run.

    python3 benchmark/control.py --workload smplh.capture16k \
        --seconds 30 --seeds 101 102 103 ... [--out readings.jsonl]

Prints one JSON line a seed and, last, the largest program reading and
the smallest control reading of each number; with `--faults` each seed
also reads one solve of its first capture under each planted fault.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true",
                    help="also one solve under each of harness/faults.py's")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from harness import faults, judge
    from harness.cell import window
    from harness.program import Program
    from harness.spec import load_cell
    from harness.world import make_world

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as wd:
            world = make_world(cell.config, cell.traffic, seed, "cuda:0", wd)
            program = Program(world, "cuda:0")
            program.solve(world.obs[0], world.mask)
            outs, ids, secs = window(program, world, args.seconds, False)
            broken = {}
            if args.faults:
                saved = faults.saved_program()
                for name, hook in faults.FAULTS.items():
                    hook(program)
                    try:
                        broken[name] = program.solve(world.obs[0],
                                                     world.mask)
                    finally:
                        faults.restore(saved, program)
            program.release()
            del program
        j = judge.Judge(world)
        sound = j.assess(outs, ids)
        ctl = j.assess(j.control_outputs(outs), ids)
        row = {"seed": seed, "solves": len(outs),
               "frames_per_s": world.frames * len(outs) / secs,
               "program": {k: sound[k] for k in judge.CHECKED},
               "control": {k: ctl[k] for k in judge.CHECKED},
               "marker_err_mm": sound["marker_err_mm"],
               "v2v_body_mm": sound["v2v_body_mm"],
               "faults": {n: {k: v for k, v in j.assess([o], [0]).items()
                              if k in judge.CHECKED}
                          for n, o in broken.items()},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del world, j, outs
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": args.seeds,
               "device": torch.cuda.get_device_name(0),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in judge.CHECKED},
               "control_min": {k: min(r["control"][k] for r in rows)
                               for k in judge.CHECKED}}
    if args.out:
        with open(args.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
            fh.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
