"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's own runs never run this):

    python3 -m bench_port.control --workload <cell> \\
        [--program-seeds a,b,...] [--control-seeds x,y,z] \\
        [--fault-seeds x,y,z] [--out FILE.json]

program  train cells only: set-up and the first steps of the timed
         training object, checked against the float32 reference (a
         render cell's program readings are its benchmark runs')
control  the reference in bfloat16 in the program's place, against the
         float32 reference: a render cell's first `check.views` views of
         the seed's orbit (a loop with `control_views`), a train cell's
         first steps
fault    train cells: the float32 reference with half of the pixels left
         out of the loss (the mean over the rest), in the program's place

One JSON line per reading, then a summary line: the largest program
reading and the smallest control and fault readings of each number."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_port import harness
from bench_port.loops import loop_type


def readings(workload, kind, seeds, dev):
    _, cell, cfg, traffic = harness.load_cell(workload)
    cls = loop_type(traffic["loop"], harness.DATA)
    for seed in seeds:
        loop = cls(cfg, traffic, seed, dev, data=harness.DATA)
        if hasattr(loop, "control_views"):
            if kind != "control":
                raise SystemExit(f"{kind} readings are for train cells")
            views = loop.control_views()
            want = loop.reference(torch.float32, views)
            got = loop.reference(torch.bfloat16, views)
        elif kind == "program":
            loop.setup()
            got = loop.answers()
            loop.release()
            want = loop.reference(torch.float32)
        else:
            want = loop.reference(torch.float32)
            got = (loop.reference(torch.bfloat16) if kind == "control"
                   else loop.reference(torch.float32, half_batch=True))
        row = {"cell": cell["name"], "kind": kind, "seed": seed,
               "numbers": loop.numbers(got, want)}
        print(json.dumps(row), flush=True)
        yield row
        del loop
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_port.control")
    p.add_argument("--workload", required=True)
    for kind in ("program", "control", "fault"):
        p.add_argument(f"--{kind}-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_port.control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    for kind in ("program", "control", "fault"):
        seeds = [int(s) for s in getattr(args, f"{kind}_seeds").split(",")
                 if s]
        rows += list(readings(args.workload, kind, seeds, dev))
    summary = {}
    for r in rows:
        for name, val in r["numbers"].items():
            s = summary.setdefault(name, {})
            pick = max if r["kind"] == "program" else min
            s[r["kind"]] = pick(s.get(r["kind"], val), val)
    print(json.dumps({"summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
