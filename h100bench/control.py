"""The readings the limits of ``limits/<workload>.json`` are set from:
the sound program's numbers over many seeds (the lower reading) and the
control's (the upper), in one process so that the set-up is paid once:

    python3 -m h100bench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

For every seed it draws that seed's pool and sample as a run does, runs
the compared calls (``check_calls`` of them) and compares them with the
reference, exactly as ``harness.run_cell`` does after its window.  The
control takes the program's place, computed one precision below the one
the configuration states: the program's own float32 path where the
configuration states float64; where it states float32 (the program has
no narrower path), the reference itself in float32 with the table
payloads and every LOS field stored in bfloat16 (arithmetic in bfloat16
throughout gives no number: the source table's 0.25 K axis collapses
there and its interpolation divides by zero).  Its first line names the
card and its power limit; then one JSON line per seed and side.  Without
a CUDA card it exits with code 2 and prints no reading.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import gen, harness
from .reference.forward import Reference

NARROWER = {"float64": "float32", "float32": "bfloat16"}


def program_answers(cfg, traffic, tables, seeds, device, precision=None):
    """{seed: (pool indices, kept answers)} of the program (in
    ``precision``, default the configuration's) on each seed."""
    out = {}
    entry = None
    for s in seeds:
        inp = gen.Inputs(cfg, traffic, s, tables)
        if entry is None:
            entry = harness.module("entries", traffic["entry"]).Entry(
                cfg, inp, device, precision)
            for i in range(int(traffic["warmup"])):
                entry.call(i)
        entry.inp = inp
        entry.kept = []
        calls = gen.check_calls(traffic, s, len(inp.pool))
        for k in calls:
            entry.call(k)
        out[s] = (calls, entry.kept)
    entry.free()
    return out


def numbers(ref: Reference, cfg, traffic, tables, seed, calls, got):
    inp = gen.Inputs(cfg, traffic, seed, tables)
    return harness.module("entries", traffic["entry"]).compare(
        ref, [inp.pool[k] for k in calls], inp.geo, inp.rows, got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    cseeds = [int(x) for x in args.control_seeds.split(",")]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, limits = harness.cell_spec(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are taken on the card only",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    info = harness.card()
    print(f"# {args.workload} on {info['kind']}, power limit "
          f"{info['power_limit']}", flush=True)
    tables = gen.make("tables", cfg)
    ft = tables[0]
    sound = program_answers(cfg, traffic, tables, seeds, device)
    narrow = NARROWER[cfg["dtype"]]
    ctrl = {}
    if narrow != "bfloat16":
        ctrl = program_answers(cfg, traffic, tables, cseeds, device, narrow)
    ref = Reference(cfg, ft, tables[1], device)
    for side, answers in (("program", sound), (f"control {narrow}", ctrl)):
        for s, (calls, got) in answers.items():
            nums = numbers(ref, cfg, traffic, tables, s, calls, got)
            print(json.dumps({"side": side, "seed": s, **nums}), flush=True)
    if narrow == "bfloat16":
        low = Reference(cfg, ft, tables[1], device, torch.float32,
                        storage=torch.bfloat16)
        for s in cseeds:
            inp = gen.Inputs(cfg, traffic, s, tables)
            calls = gen.check_calls(traffic, s, len(inp.pool))
            got = low.formod([inp.pool[k] for k in calls], inp.geo, inp.rows)
            nums = numbers(ref, cfg, traffic, tables, s, calls, got)
            print(json.dumps({"side": "control bfloat16 reference",
                              "seed": s, **nums}), flush=True)
    print(json.dumps({"limits": {k: v["limit"] for k, v in limits.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
