#!/usr/bin/env python3
"""The GSPMD mode's gather (``sharding._GatherDim``) two ways on one
card, two gloo processes sharing it as on ``chip_smoke.py``'s main paths
18 and 19:

  all_gather  ``dist.all_gather`` (the list form) and a concatenation,
              the port's;
  padded      an all-reduce of copies zero-padded to the whole width
              (every element one worker's value plus zeros: the same
              bits), the design it replaced.

    python3 gather_variants.py [--out DIR]

Each worker first gathers zamba2-7b's packed ``w_in`` output (its 7,288
columns a worker, bf16) at main path 19's training and prefill rows
(4 and 8 x 1,024 tokens) both ways, each result held bitwise the
other's, the median of ``ITERS`` wall-clock gathers in turns (forward,
then reverse). Then main path 19's zamba2-7b (12 of 81 layers, TP 2, its
build options) takes ``STEPS`` steps under each variant in turns,
all_gather, padded, padded, all_gather, each turn's median step time
after its first step. Needs one CUDA card and nvcc; exits non-zero
without them.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import chip_smoke as cs

ITERS, STEPS = 5, 3
ARCH, LAYERS = "zamba2-7b", 12
# (rows a worker's batch, tokens, columns a worker) of the packed w_in
# output: main path 19's training and prefill rows
SHAPES = {"training": (cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ, 7288),
          "prefill": (cs.SERVE_BATCH, cs.SERVE_PROMPT, 7288)}
ORDER = ("all_gather", "padded", "padded", "all_gather")


def padded_forward(ctx, t, group, dim: int, index: int, n: int):
    """``_GatherDim.forward`` by an all-reduce of zero-padded copies."""
    import torch.distributed as dist
    ctx.dim, ctx.lo, ctx.size = dim, index * t.shape[dim], t.shape[dim]
    shape = list(t.shape)
    shape[dim] *= n
    buf = t.new_zeros(shape)
    buf.narrow(dim, ctx.lo, ctx.size).copy_(t)
    dist.all_reduce(buf, group=group)
    return buf


def worker(rank: int, root: str) -> None:
    sys.path.insert(0, cs.SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding, shutdown
    from repro_torch.launch.train import build_train_setup

    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=cs.GSPMD_WORKERS)
    forwards = {"all_gather": staticmethod(sharding._GatherDim.forward),
                "padded": staticmethod(padded_forward)}

    def use(name):
        sharding._GatherDim.forward = forwards[name]

    out = {"gather_ms": {}, "step_ms": []}
    try:
        gen = torch.Generator(device="cuda").manual_seed(rank)
        for what, shape in SHAPES.items():
            t = torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            got, times = {}, {k: [] for k in forwards}
            for name in ORDER:
                use(name)
                got[name] = sharding._GatherDim.apply(t, None, 2, rank, 2)
                for _ in range(ITERS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sharding._GatherDim.apply(t, None, 2, rank, 2)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
            cs._bitwise(f"gather {what}", got["padded"], got["all_gather"])
            out["gather_ms"][what] = {
                "shape": list(shape), "bytes": t.numel() * 2 * 2,
                **{k: statistics.median(v) for k, v in times.items()}}
            del t, got
        torch.cuda.empty_cache()
        use("all_gather")
        _, state, step, data, _, _ = build_train_setup(
            cs._cut_config(ARCH, LAYERS),
            **cs._family_train_build(torch, dp_mode="gspmd",
                                     mesh_shape=cs.GSPMD_LM_MESH))
        i = 0
        for name in ORDER:
            use(name)
            times, losses = [], []
            for _ in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, data.batch_at(i))
                losses.append(float(met["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                i += 1
            out["step_ms"].append({"variant": name, "step_ms": times,
                                   "median_ms": statistics.median(times[1:]),
                                   "losses": losses})
        use("all_gather")
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import _build
    card = cs.nvidia_smi_line()
    print(card)
    _build.build(cs.SOURCES)
    root = tempfile.mkdtemp(prefix="gather_variants_")
    try:
        mp.spawn(worker, args=(root,), nprocs=cs.GSPMD_WORKERS)
        ranks = []
        for r in range(cs.GSPMD_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for what, rec in ranks[0]["gather_ms"].items():
        print(f"gather {what} {rec['shape']} bf16, a worker: all_gather "
              f"{rec['all_gather']:.2f} ms, padded all-reduce "
              f"{rec['padded']:.2f} ms (bitwise equal)")
    for rec in ranks[0]["step_ms"]:
        print(f"{ARCH} ({LAYERS} layers) TP 2 step, {rec['variant']}: "
              f"{[round(t, 1) for t in rec['step_ms']]} ms, median after "
              f"the first {rec['median_ms']:.1f}")
    result = {"card": card, "workers": ranks}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "gather_variants.json"), "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
