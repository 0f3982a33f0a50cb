"""The benchmark of the PyTorch/CUDA port: one run of one cell of
``BENCHMARK.json``, from the root of a checkout::

    python3 bench/run.py --workload resnet50.dp_b256 --seed 7 \\
        --seconds 30 --trace 0

prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (the window's steps, and those
whose loss was not finite), ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1``, which runs the traffic's ``trace_steps`` more steps
under the profiler after the window, its per-layer ones, and
``breakdown``), ``device``,
and last ``check``: each number that decided ``correct`` beside its
limit, also printed as the last lines of standard error. A cell on
several chips starts one worker process per chip (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, a rendezvous on localhost), and the
first worker's line is printed. The harness's kernel and compiler caches
stay inside the checkout, under ``bench/_cache/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds the first worker may wait for the others to end
JOIN_S = 120


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None,
                    help="set by the launcher on a cell of several chips")
    return ap.parse_args(argv)


def setup_env() -> None:
    sys.path.insert(0, BENCH)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden():
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, chips: int) -> int:
    """One worker per chip; the first worker's output is the run's."""
    port = str(_free_port())
    procs = []
    for r in range(chips):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(chips),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv, "--rank",
             str(r)], env=env,
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
    out = procs[0].communicate()[0].decode()
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=JOIN_S))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    if any(codes):
        print(f"workers exited with {codes}", file=sys.stderr)
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.write(out)
    return 0


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(man, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rank: int = 0, world: int = 1,
             wrap_step=None, cfg=None, mix=None, limits=None):
    """One run: (result line as a dict, {number: (value, limit, where)}).
    ``cfg``, ``mix`` and ``limits`` stand in for the cell's own files
    (tests at a small size); ``wrap_step`` wraps the program's step
    (tests that plant a fault)."""
    import torch

    from harness import manifest
    from harness.cell import Run, Session, check, log
    from traffic.generate import load as load_mix
    entry = manifest.cell(man, cell_name)
    cfg = cfg or manifest.config(man, entry)
    mix = mix or load_mix(entry["traffic"])
    log(f"set-up of {cell_name}, {time.perf_counter() - T_START:.3f} s "
        "after the process started")
    session = Session(cfg, mix, seed, device, rank, world, wrap_step)
    session.warm_up()
    run = Run(cfg, mix, world)
    run.setup_s = time.perf_counter() - T_START
    session.window(run, seconds)
    if trace:
        session.traced_window(run, mix["trace_steps"])
    session.finish(run)
    if rank != 0:
        return None, None
    correct, table = check(session, cell_name, limits)
    values = {}
    for m in manifest.metrics(man, cell_name, trace):
        v = manifest.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": world, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": run.steps,
              "failed": session.failed, "metrics": values, "device": dev}
    if trace:
        dev.update(busy_s=run.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    return result, table


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    setup_env()
    from harness import manifest
    man = manifest.load()
    chips = manifest.cell(man, args.workload)["chips"]
    if chips > 1 and args.rank is None:
        return launch(argv, chips)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one thread for the host's own tensor work: the step's host side is
    # the Python dispatch on the main thread, and idle pool threads that
    # spin would take the shared cores from it
    torch.set_num_threads(1)
    rank = args.rank or 0
    result, table = run_cell(man, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", rank, chips)
    if rank != 0:
        return 0
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim, _) in table.items()}
    print(json.dumps(result))
    sys.stdout.flush()
    for k, (v, lim, where) in table.items():
        print(f"check {k} {v!r} limit {lim!r} worst at {where}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
