"""The readings that the limits in ``checks/<cell>.json`` are set from,
at the cell's own size, on the chip::

    python3 bench/control.py --workload resnet50.dp_b256 \\
        --seeds 11,12,13,14 --control 3

For each seed, in one process: the program's readings of its checked
steps (the benchmark's own set-up, no window) against the reference's
(the lower readings); and for the first ``--control`` seeds, the
reference put in the program's place in fp8 (the control: every operand
of a convolution or matrix product in e4m3, every gradient into one in
e5m2) and the reference with half of each batch left out, the mean
taken over the rest (a planted fault), each against the reference (the
upper readings). A step that returns its state unchanged reads 1 on
``change_gap`` by definition and needs no run. One JSON line a seed;
the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
# the faults a one-chip training cell can have (the exchange between
# chips has none to leave out)
FAULTS = ("half", "unchanged")


def readings(cell: str, seeds, n_control: int, device: str = "cuda",
             cfg=None, mix=None):
    """Yield ``{"seed", "program", "control"?, <fault>?}`` per seed, each
    the numbers of ``harness/judge.py`` against the reference."""
    from harness import judge, manifest
    from harness.cell import Session
    from reference.common import Precision
    from traffic.generate import load as load_mix
    man = manifest.load()
    entry = manifest.cell(man, cell)
    cfg = cfg or manifest.config(man, entry)
    mix = mix or load_mix(entry["traffic"])
    for i, seed in enumerate(seeds):
        session = Session(cfg, mix, seed, device)
        session.warm_up()
        session.finish()
        ref = session.reference()
        out = {"seed": seed,
               "program": _plain(judge.numbers(session.readings, ref)),
               "quiet_leaves": len(ref["grad1"])
               - len(judge.moving_leaves(ref["grad1"]))}
        if i < n_control:
            ctrl = session.reference(Precision(fp8=True))
            out["control"] = _plain(judge.numbers(ctrl, ref))
            for fault in FAULTS:
                got = session.reference(fault=fault)
                out[fault] = _plain(judge.numbers(got, ref))
        yield out


def _plain(nums):
    return {k: v for k, (v, _) in nums.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also run the control and "
                         "the planted fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, BENCH)
    sys.path.insert(0, os.path.join(os.path.dirname(BENCH), "src"))
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.control):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
