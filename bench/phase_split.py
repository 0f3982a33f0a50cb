"""The device time of a cell's traced steps split by the program's
phases, from the root of a checkout::

    python3 bench/phase_split.py --workload resnet50.dp_b256 --seed 7

Set-up and warm-up as ``run.py`` has them, then the traffic's
``trace_steps`` steps under ``torch.profiler`` as ``--trace 1`` runs
them, and no window and no check. Prints one JSON object: device ms per
traced step launched inside each of the program's spans
(``harness/phases.py``), the share of the steps' device work that the
phases ``input``, ``forward``, ``backward``, ``sync`` and ``update``
account for, each phase's costliest device operations, the device's idle
time by the program span the host was in, the longest idle gaps
labelled with the harness span, the program span and the host operator
they fall in, and ``trace.py``'s own readings of the same
trace (busy time and gaps) beside them.
"""
from __future__ import annotations

import argparse
import json
import sys

import run

PHASES = ("input", "forward", "backward", "sync", "update")
SPANS = ("step", *PHASES, "sync.pack", "sync.all_reduce", "sync.unpack",
         "feed", "feed.wait", "feed.stage")


def split(ph, steps: int) -> dict:
    """The phase split of ``Phases`` ``ph`` over ``steps`` steps."""
    from harness.phases import PROGRAM_PREFIX
    per_ms = 1e3 / steps
    ms = {s: ph.phase_seconds(PROGRAM_PREFIX + s) * per_ms for s in SPANS}
    work = ph.step_seconds() * per_ms
    outside = ph.outside_seconds([PROGRAM_PREFIX + s for s in PHASES])
    return {
        "device_ms": ms,
        "step_work_ms": work,
        "phases_share": (sum(ms[s] for s in PHASES) / work if work else
                         None),
        "outside_phases_ms": outside * per_ms,
        "unlinked": ph.unlinked(),
        "top_ops_ms": {s: [[k, v * per_ms] for k, v in
                           ph.top_ops(PROGRAM_PREFIX + s)]
                       for s in (*PHASES, "sync.pack", "sync.unpack")},
        "idle_ms_by_span": {k: v * per_ms for k, v in
                            sorted(ph.idle_by_span().items())},
        "idle_gaps_ms": [[k, v * 1e3] for k, v in ph.idle_gaps()],
    }


def measure(cfg: dict, mix: dict, seed: int, device: str = "cuda") -> dict:
    """Set-up, warm-up and the traced steps of one run; the split."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                record_function, schedule)

    from harness import phases, trace
    from harness.cell import Session
    session = Session(cfg, mix, seed, device)
    session.warm_up()
    steps, warm = mix["trace_steps"], 2
    plan = schedule(wait=0, warmup=warm, active=steps, repeat=1)
    acts = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    step_s = []
    with profile(activities=acts, schedule=plan) as prof:
        for i in range(warm + steps):
            dt, _, _, _ = session._step(record_function)
            if i >= warm:
                step_s.append(dt)
            if i == warm + steps - 1:
                with record_function("bench.sync"):
                    if session.device.type == "cuda":
                        torch.cuda.synchronize()
            prof.step()
    session.finish()
    window = ("bench.data_wait", "bench.sync")
    out = split(phases.from_profiler(prof, window), steps)
    tr = trace.from_profiler(prof, window)
    out["trace_busy_ms"] = tr.busy_s * 1e3 / steps
    out["trace_idle_gaps_ms"] = [[k, v * 1e3] for k, v in tr.idle_gaps()]
    out["traced_step_ms"] = [s * 1e3 for s in step_s]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.setup_env()
    import torch

    from harness import manifest
    from traffic.generate import load as load_mix
    man = manifest.load()
    entry = manifest.cell(man, args.workload)
    if entry["chips"] != 1 or not torch.cuda.is_available():
        print(f"{args.workload}: this tool runs one-chip cells on a card",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = measure(manifest.config(man, entry), load_mix(entry["traffic"]),
                  args.seed)
    out["device"] = torch.cuda.get_device_name(0)
    out["power_limit"] = run.power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
