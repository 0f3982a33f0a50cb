#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and is right there.

    python3 chip_smoke.py [--out DIR] [--profile] [--turns N]

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all started together);
  3. kernels: each of the four fused-BN kernels against its plain
     PyTorch version on the card, at every BN-site shape of ResNet-50 at
     batch 32 (stem 401,408 x 64 down to stage 3 1,568 x 2,048), in bf16
     and f32, with kernel, plain and library times (CUDA events) and the
     HBM-bytes bound of each shape;
  3b. the fused update, the wire cast and the fused input kernels against
     their plain versions, bitwise: ``hybrid_update`` at every distinct
     ResNet-50 leaf size and the whole 25.56 M-element stream (decay
     none, scalar and a stream; a_sgd 0, 0.5 and 1), ``cast_copy`` to
     bf16/f16 and back at the whole stream and odd lengths,
     ``input_train``/``input_eval`` at (32, 224, 224, 3) with +-4 shifts
     and flips, bf16 and f32 out; with kernel, plain, library and bound
     times per main-path step;
  3c. the stream-LARS kernels against their plain versions:
     ``seg_sq_partials`` within rtol 1e-5 of a float64 sum of the same
     inputs and the same bits on a second launch, ``lars_update``
     bitwise, at ResNet-50's whole stream (162 segments), at the
     worker slices of an ``align=4`` plan for 2 and 4 workers, with zero
     gradients, and at edge cases (1 element, an empty segment,
     1-element segments, a segment across the kernels' chunks, a length
     not a multiple of 128); with kernel, plain and bound times, and
     ``hybrid_update`` timed with the per-element decay stream;
  4. main path 1 (slice 1, one device):
     ``repro_torch.launch.train.build_train_setup`` for the full-width
     ResNet-50 (stages 3,4,6,3, width 64, 1000 classes, 224
     px), global batch 32, bf16, fused BN, rmsprop_warmup + slow_start,
     bf16 wire cast, driven by the ``Trainer`` for one epoch of 8
     steps and one eval batch; launch counts must be 53 per
     train step (and 53 more per eval batch for bn_apply);
  5. reference: the reduced ResNet in f32 on the card, fused kernels vs
     the unfused plain path, three steps from the same seed;
  6. main path 2, the paper's data-parallel step at world size 1 (NCCL):
     the same model and recipe with ``dp_mode="shardmap"``, the bucketed
     bf16 all-reduce, the fused update, the fused input and a 4-worker
     feed, 8 steps and one eval batch after the BN all-reduce; every
     kernel's launch count is checked;
  6b. reference: the reduced ResNet in f32, the DP step with every new
     kernel on against the same step with them off (plain per-leaf
     update, per-leaf all-reduce, host input transform), three steps;
  8. main path 3, stream-LARS on the DP step at world size 1 (NCCL):
     main path 2 with the ``lars_ls_poly`` recipe (LARS, poly schedule,
     label smoothing 0.1); the update runs on the packed stream through
     ``seg_sq_partials`` and ``lars_update``, once each per step, and
     ``hybrid_update`` never; every launch count is checked;
  8b. reference: the reduced ResNet in f32, the stream-LARS DP step with
     error feedback, twice with the kernels on (bitwise equal) and once
     with the plain stream update (losses within rtol 1e-5, parameters
     within a relative norm of 1e-5), three steps.
With ``--profile``, a few more steps of each main path run under
torch.profiler (device busy time and idle share, top host ops and
kernels). With ``--turns N``, phase 7 runs the main paths again in
turns, N times: main path 2, main path 2 fed pre-made batches (its
producer threads then only hand them over), main path 1 twice, then the
two variants of main path 2 in reverse, for their wall step times side
by side. Then a ``{"kernels": [...]}`` line (launches from main path
2 for its eight kernels, from main path 3 for the two stream-LARS
kernels; ``launches_by_path`` holds both), the card's name and power
limit, and
last the ``{"ok": true, "device": ...}`` line. ``--out DIR`` also writes
the per-shape kernel tables to ``DIR/chip_smoke_kernels.json``.

It exits non-zero before printing any result when no CUDA device is
present or when the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, same sheet
BATCH = 32  # the paper's per-GPU minibatch (32,768 over 1,024 GPUs)
STEPS = 8  # main-path train steps: the first is set-up, 7 are timed
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "fused_bn.cu"
REPLACES = {"bn_stats": "src/repro/kernels/fused_bn.py:54",
            "bn_apply": "src/repro/kernels/fused_bn.py:90",
            "bn_bwd_sums": "src/repro/kernels/fused_bn.py:108",
            "bn_bwd_dx": "src/repro/kernels/fused_bn.py:132"}
KERNELS = tuple(REPLACES)
# the kernels of main path 2 beyond fused BN: source, the Pallas body
# each replaces (the variants ride on the same kernel: _kernel_wd through
# hybrid_update's wd pointer)
NEW_KERNELS = {
    "hybrid_update": ("fused_update.cu",
                      "src/repro/kernels/fused_update.py:24"),
    "cast_copy": ("bucket_ops.cu", "src/repro/kernels/bucket_ops.py:30"),
    "input_train": ("fused_input.cu", "src/repro/kernels/fused_input.py:41"),
    "input_eval": ("fused_input.cu", "src/repro/kernels/fused_input.py:50"),
}
# the kernels of main path 3 beyond those of main path 2
LARS_KERNELS = {
    "seg_sq_partials": ("fused_update.cu",
                        "src/repro/kernels/fused_update.py:130"),
    "lars_update": ("fused_update.cu",
                    "src/repro/kernels/fused_update.py:189"),
}
SOURCES = ("fused_bn", "fused_update", "bucket_ops", "fused_input")
# flops per element of the hybrid update (decay 2, m 4, coef 4, delta 3,
# theta 2) and of the input transform (subtract, multiply)
UPDATE_FLOPS, INPUT_FLOPS = 15, 2
# per element: seg_sq_partials g + wd*p (2), two squares, two sums; the
# LARS update g + wd*p (2), mu1*d, t*g', their difference, eta*d', p + .
SEG_SQ_FLOPS, LARS_FLOPS = 6, 7
BUCKET_BYTES = 64 * 1024 * 1024
# kernel vs plain, |k - p| <= atol + rtol * |p| elementwise; the sums are
# held relative to the sum of the magnitudes they add (reduction order)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=2e-2)}
SUM_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bn_sites(cfg, batch: int):
    """(name, rows, C, relu, residual) of every BN site of the ResNet, in
    forward order, from the model's SAME-padding arithmetic."""
    w = cfg.conv_width
    s = -(-cfg.image_size // 2)  # stem conv, stride 2
    sites = [("stem/bn", batch * s * s, w, True, False)]
    s = -(-s // 2)  # max-pool, stride 2
    for si, blocks in enumerate(cfg.conv_stages):
        mid, c_out = w * 2 ** si, w * 2 ** si * 4
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            s_out = -(-s // stride)
            pre = f"stage{si}/block{bi}"
            if bi == 0:
                sites.append((f"{pre}/proj_bn", batch * s_out ** 2, c_out,
                              False, False))
            sites.append((f"{pre}/bn1", batch * s * s, mid, True, False))
            sites.append((f"{pre}/bn2", batch * s_out ** 2, mid, True,
                          False))
            sites.append((f"{pre}/bn3", batch * s_out ** 2, c_out, True,
                          True))
            s = s_out
    return sites


def time_ms(torch, fn, iters: int = 10, trials: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured
    into a CUDA graph and the replays timed with CUDA events (median of
    ``trials``), so the host's dispatch cost is left out. Inputs stay in
    L2 between calls where they fit (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def time_eager_ms(torch, fn, iters: int = 5) -> float:
    """Device time of one call of ``fn`` where it cannot be captured in a
    graph (it reads values on the host): ``iters`` calls between two
    CUDA events, their host waits included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def site_bytes(rows: int, c: int, esize: int, relu: bool, res: bool):
    """Bytes each kernel must move at one site: every input read once,
    every output written once (per-channel vectors in f32)."""
    act = rows * c * esize
    return {
        "bn_stats": act + 2 * c * 4,
        "bn_apply": act * (2 + res) + 4 * c * 4,
        "bn_bwd_sums": act * (2 + relu) + 4 * c * 4,
        "bn_bwd_dx": act * (3 + relu + res) + 5 * c * 4,
    }


def kernel_phase(torch, fb, cfg, out_rows):
    """Every kernel at every distinct site shape, bf16 and f32. Returns
    per-step totals over the 53 sites (bf16, the main path's dtype)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    groups = {}
    for _, rows, c, relu, res in bn_sites(cfg, BATCH):
        key = (rows, c, relu, res)
        groups[key] = groups.get(key, 0) + 1
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0} for k in KERNELS}
    pair = {"fwd_ms": 0.0, "fwd_library_ms": 0.0, "bwd_ms": 0.0,
            "bwd_library_ms": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        esize = 2 if dtype == torch.bfloat16 else 4
        for (rows, c, relu, res), count in sorted(groups.items()):
            def rnd(*shape, dt=dtype, gen=gen):
                return (torch.randn(*shape, generator=gen, device=dev) * 2
                        + 0.5).to(dt)

            x, dy = rnd(rows, c), rnd(rows, c)
            r = rnd(rows, c) if res else None
            scale = 1 + 0.1 * rnd(c, dt=torch.float32)
            bias = 0.1 * rnd(c, dt=torch.float32)
            mean, var = fb.bn_stats(x)
            pmean, pvar = fb.PLAIN["bn_stats"](x)
            rstd = torch.rsqrt(pvar + 1e-5)
            a = rstd * scale
            o = bias - pmean * a
            y = fb.bn_apply(x, a, o, r, relu)
            py = fb.PLAIN["bn_apply"](x, a, o, r, relu)
            s1, s2 = fb.bn_bwd_sums(dy, x, py, pmean, rstd, relu)
            p1, p2 = fb.PLAIN["bn_bwd_sums"](dy, x, py, pmean, rstd, relu)
            cb, cc = a * p1 / rows, a * p2 / rows
            dx, dres = fb.bn_bwd_dx(dy, x, py, pmean, rstd, a, cb, cc, relu,
                                    res)
            pdx, pdres = fb.PLAIN["bn_bwd_dx"](dy, x, py, pmean, rstd, a, cb,
                                               cc, relu, res)
            torch.cuda.synchronize()
            # --- hold each kernel against its plain version
            x32 = x.float()
            dym = dy.float() if not relu else torch.where(
                py > 0, dy.float(), torch.zeros((), device=dev))
            xhat = (x32 - pmean) * rstd
            errs = {}

            def sum_err(name, got, want, mag):
                bad = ((got - want).abs() / (mag + 1e-30)).max().item()
                if not bad <= SUM_TOL:
                    raise AssertionError(
                        f"{name} {dname} rows={rows} C={c}: error "
                        f"{bad:.3g} of the summed magnitude > {SUM_TOL}")
                return (got - want).abs().max().item()

            errs["bn_stats"] = max(
                sum_err("bn_stats mean", mean, pmean,
                        x32.abs().mean(0)),
                sum_err("bn_stats var", var, pvar,
                        (x32 - pmean).square().mean(0)))
            errs["bn_bwd_sums"] = max(
                sum_err("bn_bwd_sums S1", s1, p1, dym.abs().sum(0)),
                sum_err("bn_bwd_sums S2", s2, p2, (dym * xhat).abs().sum(0)))
            for name, got, want in (("bn_apply", y, py), ("bn_bwd_dx", dx, pdx),
                                    ("bn_bwd_dx dres", dres, pdres)):
                if got is None:
                    continue
                torch.testing.assert_close(
                    got.float(), want.float(), **TOL[dname],
                    msg=lambda m, n=name: f"{n} {dname} rows={rows} C={c}: "
                    f"{m}")
                key = name.split()[0]
                errs[key] = max(errs.get(key, 0.0),
                                (got.float() - want.float()).abs().max()
                                .item())
            # --- times: kernel, plain version, library yardstick
            calls = {
                "bn_stats": (lambda: fb.bn_stats(x),
                             lambda: fb.PLAIN["bn_stats"](x),
                             lambda: torch.var_mean(x, 0, correction=0)),
                "bn_apply": (lambda: fb.bn_apply(x, a, o, r, relu),
                             lambda: fb.PLAIN["bn_apply"](x, a, o, r, relu),
                             lambda: F.batch_norm(x, lm, lv, lw, lb,
                                                  training=False)),
                "bn_bwd_sums": (
                    lambda: fb.bn_bwd_sums(dy, x, py, pmean, rstd, relu),
                    lambda: fb.PLAIN["bn_bwd_sums"](dy, x, py, pmean, rstd,
                                                    relu), None),
                "bn_bwd_dx": (
                    lambda: fb.bn_bwd_dx(dy, x, py, pmean, rstd, a, cb, cc,
                                         relu, res),
                    lambda: fb.PLAIN["bn_bwd_dx"](dy, x, py, pmean, rstd, a,
                                                  cb, cc, relu, res), None),
            }
            # the yardsticks take their per-channel vectors in x's dtype
            lw, lb, lm, lv = (t.to(dtype) for t in (scale, bias, pmean,
                                                     pvar))
            nbytes = site_bytes(rows, c, esize, relu, res)
            row = {"dtype": dname, "rows": rows, "C": c, "relu": relu,
                   "residual": res, "sites": count}
            for k, (kern, plain, lib) in calls.items():
                row[k] = {
                    "ms": time_ms(torch, kern),
                    "plain_ms": time_ms(torch, plain),
                    "library_ms": (time_ms(torch, lib) if lib is not None
                                   else None),
                    "bound_ms": nbytes[k] / HBM_BYTES_PER_S * 1e3,
                    "max_abs_err": errs[k],
                }
            # the site pair against PyTorch's batch norm (training) forward
            # and its backward, one call each
            _, smean, sinv = torch.ops.aten.native_batch_norm(
                x, lw, lb, None, None, True, 0.1, 1e-5)
            row["pair"] = {
                "fwd_ms": row["bn_stats"]["ms"] + row["bn_apply"]["ms"],
                "fwd_library_ms": time_ms(
                    torch, lambda: torch.ops.aten.native_batch_norm(
                        x, lw, lb, None, None, True, 0.1, 1e-5)),
                "bwd_ms": row["bn_bwd_sums"]["ms"] + row["bn_bwd_dx"]["ms"],
                "bwd_library_ms": time_ms(
                    torch, lambda: torch.ops.aten.native_batch_norm_backward(
                        dy, x, lw, None, None, smean, sinv, True, 1e-5,
                        [True, True, True])),
            }
            out_rows.append(row)
            log(f"  {dname:4s} rows={rows:7d} C={c:5d} relu={int(relu)} "
                f"res={int(res)} x{count:2d}  " + "  ".join(
                    f"{k}={row[k]['ms'] * 1e3:7.1f}us"
                    f"(plain {row[k]['plain_ms'] * 1e3:7.1f},"
                    f" bound {row[k]['bound_ms'] * 1e3:6.1f})"
                    for k in KERNELS))
            for k in KERNELS:
                totals[k]["max_abs_err"] = max(totals[k]["max_abs_err"],
                                               errs[k])
                if dname == "bf16":
                    for f in ("ms", "plain_ms", "bound_ms"):
                        totals[k][f] += count * row[k][f]
                    lib = row[k]["library_ms"]
                    totals[k]["library_ms"] = (
                        None if lib is None or totals[k]["library_ms"] is None
                        else totals[k]["library_ms"] + count * lib)
            if dname == "bf16":
                for f in pair:
                    pair[f] += count * row["pair"][f]
    return totals, pair


def bound(nbytes: float, flops: float):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the float32 operations over the card's float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def model_params(cfg):
    """The parameters of the port's own ResNet, built on the CPU."""
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    return {k: p.detach() for k, p in model.named_parameters()}


def model_leaves(params):
    """(name, elements, decays) of every parameter leaf."""
    from repro_torch.optim.rmsprop_warmup import decays
    return [(k, p.numel(), decays(k)) for k, p in params.items()]


def _bitwise(name: str, got, want) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit (same dtype and
    shape, every element equal)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not bool((got == want).all()):
        diff = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by up to {diff:.3g}")


def update_phase(torch, leaves, wd: float):
    """``hybrid_update`` bitwise against its plain version at every
    distinct leaf size and the whole stream, then timed per main-path
    step: one launch per leaf, each leaf at its own size and decay."""
    from collections import Counter

    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    total = sum(n for _, n, _ in leaves)

    def tensors(n):
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        p = torch.randn(n, generator=gen, device=dev) * 0.05
        d = torch.randn(n, generator=gen, device=dev) * 1e-3
        m = torch.rand(n, generator=gen, device=dev) * 1e-6
        m[:n // 4] = 0.0  # the state of the first step
        return g, p, d, m

    sizes = sorted({n for _, n, _ in leaves} | {total})
    for n in sizes:
        g, p, d, m = tensors(n)
        stream = (torch.rand(n, generator=gen, device=dev) < 0.5).float() * wd
        for dname, dec in (("none", 0.0), ("scalar", wd), ("stream", stream)):
            for a_sgd in (0.0, 0.5, 1.0):
                h = HybridHyper(eta=0.1, alpha_sgd=a_sgd)
                kern = [t.clone() for t in (p, d, m)]
                plain = [t.clone() for t in (p, d, m)]
                fu.fused_hybrid_update(g, *kern, h, dec)
                fu.PLAIN["hybrid_update"](g, *plain, h, dec)
                for what, a, b in zip(("theta", "delta", "m"), kern, plain):
                    _bitwise(f"hybrid_update n={n} wd={dname} "
                             f"a_sgd={a_sgd} {what}", a, b)
    log(f"  hybrid_update bitwise at {len(sizes)} sizes (1 .. {total}) x "
        f"decay none/scalar/stream x a_sgd 0/0.5/1")
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
           "max_abs_err": 0.0}
    nbytes = flops = 0
    for (n, dec), count in sorted(Counter((n, dec)
                                          for _, n, dec in leaves).items()):
        g, p, d, m = tensors(n)
        w = wd if dec else 0.0
        out["ms"] += count * time_ms(
            torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, w))
        out["plain_ms"] += count * time_ms(
            torch, lambda: fu.PLAIN["hybrid_update"](g, p, d, m, h, w))
        nbytes += count * 28 * n  # read g, p, d, m; write p, d, m
        flops += count * UPDATE_FLOPS * n
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    g, p, d, m = tensors(total)
    out["one_launch_stream_ms"] = time_ms(
        torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, wd))
    # the per-element decay stream (the _kernel_wd variant) over the
    # whole stream: read g, p, d, m, wd; write p, d, m
    wds = torch.cat([torch.full((n,), wd if dec else 0.0, device=dev)
                     for _, n, dec in leaves])
    out["wd_stream_ms"] = time_ms(
        torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, wds))
    out["wd_stream_plain_ms"] = time_ms(
        torch, lambda: fu.PLAIN["hybrid_update"](g, p, d, m, h, wds))
    out["wd_stream_bound_ms"], _ = bound(32 * total,
                                         (UPDATE_FLOPS + 2) * total)
    log(f"  hybrid_update per step ({len(leaves)} leaves, {total} "
        f"elements): {out['ms']:.3f} ms (plain {out['plain_ms']:.3f}, "
        f"bound {out['bound_ms']:.3f}); the whole stream in one launch "
        f"{out['one_launch_stream_ms']:.3f} ms; with the decay stream "
        f"{out['wd_stream_ms']:.3f} ms (plain "
        f"{out['wd_stream_plain_ms']:.3f}, bound "
        f"{out['wd_stream_bound_ms']:.3f})")
    return out, total


def cast_phase(torch, total: int):
    """``cast_copy`` (``pack_cast`` / ``unpack_cast``) bitwise against
    ``Tensor.to`` at odd lengths and the whole stream, to bf16 and f16
    and back; timed as one pack and one unpack of the bf16 stream, the
    main path's casts per step."""
    from repro_torch.kernels import bucket_ops as bo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    for n in (1, 127, 128 * 1024 + 3, total):
        x = torch.randn(n, generator=gen, device=dev) * 3
        # overflow, underflow and subnormals of the half formats
        edge = torch.tensor([7e4, -1e5, 1e-8, -3e-6, 6.1e-5, 3e38, 1e-40,
                             0.0], device=dev)[:n]
        x[:edge.numel()] = edge
        for wire in (bf16, torch.float16):
            packed = bo.pack_cast(x, wire)
            _bitwise(f"pack_cast n={n} {wire}", packed, x.to(wire))
            _bitwise(f"unpack_cast n={n} {wire}", bo.unpack_cast(packed),
                     packed.to(f32))
    log(f"  cast_copy bitwise at n = 1, 127, {128 * 1024 + 3}, {total}, "
        f"bf16 and f16, both ways")
    x = torch.randn(total, generator=gen, device=dev)
    w = x.to(bf16)
    out = {
        "ms": time_ms(torch, lambda: bo.pack_cast(x, bf16))
        + time_ms(torch, lambda: bo.unpack_cast(w)),
        "plain_ms": time_ms(torch, lambda: bo.PLAIN["cast_copy"](x, bf16))
        + time_ms(torch, lambda: bo.PLAIN["cast_copy"](w, f32)),
        "library_ms": time_ms(torch, lambda: x.to(bf16))
        + time_ms(torch, lambda: w.to(f32)),
        "max_abs_err": 0.0}
    out["bound_ms"], out["bound_by"] = bound(2 * 6 * total, 0)
    log(f"  cast_copy per step (pack + unpack, {total} elements): "
        f"{out['ms']:.3f} ms (plain {out['plain_ms']:.3f}, Tensor.to "
        f"{out['library_ms']:.3f}, bound {out['bound_ms']:.3f})")
    return out


def input_phase(torch, cfg):
    """``input_train`` and ``input_eval`` bitwise against their plain
    versions at the main path's batch, float32 pixels in and bf16 / f32
    out, with a table holding +-4 shifts and flips; timed in bf16."""
    from repro_torch.kernels import fused_input as fi
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    s = cfg.image_size
    x = torch.randn(BATCH, s, s, 3, generator=gen, device=dev) * 50 + 120
    table = torch.from_numpy(fi.input_augment_params(0, 5, BATCH)).to(dev)
    table[:4] = torch.tensor([[1, 4, -4, 0], [0, -4, 4, 0], [1, 0, 0, 0],
                              [1, -4, -4, 0]], dtype=torch.int32)
    mean = torch.tensor([123.7, 116.3, 103.5], device=dev)
    inv = 1.0 / torch.tensor([58.4, 57.1, 57.4], device=dev)
    for dt in (torch.bfloat16, torch.float32):
        _bitwise(f"input_train {dt}",
                 fi.fused_input_train(x, table, mean, inv, out_dtype=dt),
                 fi.PLAIN["input_train"](x, table, mean, inv, dt))
        _bitwise(f"input_eval {dt}",
                 fi.fused_input_eval(x, mean, inv, out_dtype=dt),
                 fi.PLAIN["input_eval"](x, mean, inv, dt))
    log(f"  input_train / input_eval bitwise at {tuple(x.shape)}, bf16 "
        f"and f32 out")
    bf16, n = torch.bfloat16, x.numel()
    out = {}
    for name, kern, plain in (
            ("input_train",
             lambda: fi.fused_input_train(x, table, mean, inv,
                                          out_dtype=bf16),
             lambda: fi.PLAIN["input_train"](x, table, mean, inv, bf16)),
            ("input_eval",
             lambda: fi.fused_input_eval(x, mean, inv, out_dtype=bf16),
             lambda: fi.PLAIN["input_eval"](x, mean, inv, bf16))):
        rec = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None, "max_abs_err": 0.0}
        extra = BATCH * 16 if name == "input_train" else 0  # the table
        rec["bound_ms"], rec["bound_by"] = bound(n * 6 + extra + 24,
                                                 INPUT_FLOPS * n)
        out[name] = rec
        log(f"  {name} per call: {rec['ms']:.4f} ms (plain "
            f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f})")
    return out


def lars_phase(torch, params, weight_decay: float):
    """``seg_sq_partials`` and ``lars_update`` against their plain
    versions and ``seg_sq_partials`` against a float64 sum, at
    ResNet-50's whole stream (the ``align=1`` plan of world size 1),
    the worker slices of an ``align=4`` plan for 2 and 4 workers, the
    whole stream with zero gradients, and edge cases; every case is
    timed. Returns the records of the whole stream (the main path's
    shape at world size 1) and of every case."""
    from repro_torch.distributed.bucketing import (local_shard, plan_buckets,
                                                   segment_ids_stream)
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim.stream import decay_wd_stream, trust_mask_segments
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def rnd(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    def stream(plan):
        n = plan.padded_total
        pgd = [rnd(n, 0.05), rnd(n, 1e-3), rnd(n, 1e-3)]
        for t in pgd:
            t[plan.total_elems:] = 0.0  # the pad holds zeros
        wd = torch.from_numpy(decay_wd_stream(params, plan,
                                              weight_decay)).to(dev)
        seg = torch.from_numpy(segment_ids_stream(plan)).to(dev)
        mask = torch.from_numpy(trust_mask_segments(params, plan)).to(dev)
        trust = torch.where(mask, torch.rand(mask.numel(), generator=gen,
                                             device=dev) * 1e-2, 1.0)
        return (*pgd, wd, seg, trust)

    cases = {}
    plan1 = plan_buckets(params, BUCKET_BYTES, "bf16", align=1)
    full = stream(plan1)
    cases["stream"] = full
    p, g, d, wd, seg, trust = full
    cases["stream_zero_grad"] = (p, torch.zeros_like(g), d, wd, seg, trust)
    plan4 = plan_buckets(params, BUCKET_BYTES, "bf16", align=4)
    whole4 = stream(plan4)
    for n in (2, 4):
        for w in range(n):
            cases[f"shard{w}of{n}"] = tuple(
                local_shard(t, plan4, n, w) if t.numel() == plan4.padded_total
                else t for t in whole4)
    # 1 element; an empty segment; 1-element segments; a segment across
    # the chunks of the first pass; a length not a multiple of 128
    for name, sizes in (("one_element", [1]),
                        ("edges", [1, 0, 1, 1, 5000, 4095, 1, 8193, 3])):
        n = sum(sizes)
        seg_e = torch.repeat_interleave(
            torch.arange(len(sizes), dtype=torch.int32, device=dev),
            torch.tensor(sizes, device=dev))
        trust_e = torch.rand(len(sizes), generator=gen, device=dev) * 1e-2
        trust_e[::2] = 1.0
        wd_e = (torch.rand(n, generator=gen, device=dev) < 0.5).float() \
            * weight_decay
        cases[name] = (rnd(n, 0.05), rnd(n, 1e-3), rnd(n, 1e-3), wd_e, seg_e,
                       trust_e)
    eta, mu1 = 0.1, 0.9
    records = {}
    for name, (p, g, d, wd, seg, trust) in cases.items():
        n, n_seg = p.numel(), trust.numel()
        got = fu.fused_segment_sq_partials(p, g, wd, seg, n_seg)
        again = fu.fused_segment_sq_partials(p, g, wd, seg, n_seg)
        plain = fu.PLAIN["seg_sq_partials"](p, g, wd, seg, n_seg)
        p64, ge64 = p.double(), g.double() + wd.double() * p.double()
        want = torch.zeros(2, n_seg, dtype=torch.float64, device=dev)
        want.index_add_(1, seg.long(), torch.stack([p64 * p64, ge64 * ge64]))
        repeat = torch.equal(got, again)
        rel = ((got.double() - want).abs() / want.clamp_min(1e-300)).max()
        if not (repeat and rel.item() <= 1e-5
                and bool((got[want == 0] == 0).all())):
            raise AssertionError(f"seg_sq_partials {name}: repeatable "
                                 f"{repeat}, rel err vs f64 {rel.item():.3g}")
        kern, ref = [p.clone(), d.clone()], [p.clone(), d.clone()]
        fu.fused_lars_update(g, *kern, wd, seg, trust, eta, mu1)
        fu.PLAIN["lars_update"](g, *ref, wd, seg, trust, eta, mu1)
        _bitwise(f"lars_update {name} p", kern[0], ref[0])
        _bitwise(f"lars_update {name} d", kern[1], ref[1])
        sq_bound, sq_by = bound(16 * n + 8 * n_seg, SEG_SQ_FLOPS * n)
        up_bound, up_by = bound(28 * n + 4 * n_seg, LARS_FLOPS * n)
        rec = {
            "elements": n, "segments": n_seg,
            "seg_sq_partials": {
                "ms": time_ms(torch, lambda: fu.fused_segment_sq_partials(
                    p, g, wd, seg, n_seg)),
                "plain_ms": time_eager_ms(
                    torch, lambda: fu.PLAIN["seg_sq_partials"](
                        p, g, wd, seg, n_seg)),
                "bound_ms": sq_bound, "bound_by": sq_by, "library_ms": None,
                "max_abs_err": (got - plain).abs().max().item(),
                "rel_err_f64": rel.item(), "repeatable": repeat},
            "lars_update": {
                "ms": time_ms(torch, lambda: fu.fused_lars_update(
                    g, kern[0], kern[1], wd, seg, trust, eta, mu1)),
                "plain_ms": time_ms(torch, lambda: fu.PLAIN["lars_update"](
                    g, ref[0], ref[1], wd, seg, trust, eta, mu1)),
                "bound_ms": up_bound, "bound_by": up_by, "library_ms": None,
                "max_abs_err": 0.0},
        }
        if name == "stream":  # a yardstick: index_add_ of the squares
            sq = torch.stack([p * p, (g + wd * p).square()])
            seg64 = seg.long()
            rec["index_add_ms"] = time_ms(
                torch, lambda: torch.zeros(2, n_seg, device=dev).index_add_(
                    1, seg64, sq))
        records[name] = rec
        r, u = rec["seg_sq_partials"], rec["lars_update"]
        log(f"  {name:16s} n={n:9d} segs={n_seg:3d}  seg_sq_partials "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f}; rel err vs f64 {r['rel_err_f64']:.2g}, "
            f"repeatable)  lars_update {u['ms']:.4f} ms (plain "
            f"{u['plain_ms']:.4f}, bound {u['bound_ms']:.4f}; bitwise)")
    log(f"  index_add_ of the precomputed squares (whole stream): "
        f"{records['stream']['index_add_ms']:.4f} ms")
    return {k: records["stream"][k] for k in LARS_KERNELS}, records


def reset_counts(libs) -> None:
    for lib in libs:
        lib.reset_launch_counts()


def read_counts(libs):
    return {k: v for lib in libs for k, v in lib.LAUNCHES.items()}


def check_state(torch, state, p0) -> None:
    """Every tensor of the train state on the card and finite, and every
    parameter changed by the steps."""
    tensors = list(state["params"].values())
    for v in state["opt"].values():  # per-leaf dicts, or flat streams
        tensors += list(v.values()) if isinstance(v, dict) else (
            [v] if torch.is_tensor(v) else [])
    for rec in state["model_state"].values():
        tensors += list(rec.values())
    assert all(t.device.type == "cuda" for t in tensors), "tensor off card"
    assert all(bool(torch.isfinite(t).all()) for t in tensors), \
        "non-finite state"
    changed = sum(not torch.equal(p0[k], v)
                  for k, v in state["params"].items())
    assert changed == len(p0), f"only {changed}/{len(p0)} params changed"


def main_path(torch, libs, cfg, steps: int):
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup
    from repro_torch.training import Trainer, TrainerConfig

    t0 = time.perf_counter()
    model, state, train_step, data, _, _ = build_train_setup(
        cfg, global_batch=BATCH, seq_len=0, opt_cfg=OptimizerConfig(),
        steps_per_epoch=steps, compute_dtype=torch.bfloat16, fused_bn=True,
        compression="bf16", device="cuda")
    eval_step, val_data, finalize = build_eval_setup(
        model, cfg, global_batch=BATCH, seq_len=0)
    n_params = sum(p.numel() for p in state["params"].values())
    log(f"  setup {time.perf_counter() - t0:.1f}s: {n_params} parameters, "
        f"{len(state['model_state'])} BN sites")
    p0 = {k: v.clone() for k, v in state["params"].items()}
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1)
    trainer = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                      val_data=val_data, finalize_state=finalize)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    result = trainer.run()
    torch.cuda.synchronize()
    launches = read_counts(libs)
    state = result.state

    losses = [h["loss"] for h in result.history]
    log(f"  losses {losses}")
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    check_state(torch, state, p0)
    sites = len(state["model_state"])
    assert sites == 53, sites
    # slice 1's path runs the fused-BN kernels only
    want = {k: 0 for k in launches}
    want.update(bn_stats=sites * steps, bn_bwd_sums=sites * steps,
                bn_bwd_dx=sites * steps,
                bn_apply=sites * steps + sites * tcfg.val_batches)
    log(f"  launches {launches} (want {want})")
    assert launches == want, (launches, want)
    ev = result.epoch_history[-1]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["top1"] <= 1.0, ev
    step_s = [h["time"] - h["data_wait"] for h in result.history[1:]]
    med = statistics.median(step_s)
    stats = {"steps": steps, "median_step_ms": med * 1e3,
             "images_per_s": BATCH / med,
             "median_wall_ms": statistics.median(
                 h["time"] for h in result.history[1:]) * 1e3,
             "step_ms": [t * 1e3 for t in step_s],
             "first_step_ms": (result.history[0]["time"]
                               - result.history[0]["data_wait"]) * 1e3,
             "data_ms_median": statistics.median(
                 h["data_wait"] for h in result.history) * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "eval": {k: ev[k] for k in ("top1", "loss")}}
    log(f"  median step {stats['median_step_ms']:.2f} ms, "
        f"{stats['images_per_s']:.1f} images/s (bf16, batch {BATCH}; "
        f"host wall time of the step, batch generation excluded); peak "
        f"{stats['peak_mem_gib']:.2f} GiB; eval {stats['eval']}")
    return launches, stats, (train_step, state, data)


def profile_phase(torch, train_step, state, data, steps: int = 3):
    """``--profile``: ``steps`` more main-path steps under torch.profiler.
    Returns the window's wall time, the summed device kernel time (one
    stream, so its busy time), and the top host ops and kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [data.batch_at(1000 + i) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = train_step(state, b)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    top_k = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    out = {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": device_s / steps * 1e3,
        "device_idle_share": 1.0 - device_s / wall if wall else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_host_ops": [(e.key, e.count // steps,
                          e.self_cpu_time_total / steps / 1e3)
                         for e in host],
        "top_kernels": [(e.key[:90], e.count // steps,
                         e.self_device_time_total / steps / 1e3)
                        for e in top_k],
    }
    log(f"  per step: wall {out['wall_ms_per_step']:.2f} ms, device busy "
        f"{out['device_busy_ms_per_step']:.2f} ms (idle share "
        f"{out['device_idle_share']:.3f}), "
        f"{out['kernel_launches_per_step']:.0f} kernels")
    for name, n, ms in out["top_host_ops"]:
        log(f"    host {ms:8.3f} ms x{n:5d} {name}")
    for name, n, ms in out["top_kernels"]:
        log(f"    device {ms:8.3f} ms x{n:5d} {name}")
    return out


def param_rel_norm(a, b) -> float:
    """Relative norm of the difference of two parameter dicts, in
    float64: |a - b| / |b|."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


def reference_phase(torch):
    """Reduced ResNet, f32 on the card: the fused kernels against the
    unfused plain path, three train steps from one seed."""
    from repro_torch.configs import OptimizerConfig, get_config, \
        reduced_config
    from repro_torch.launch.train import build_train_setup

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config("resnet50"))
    runs = {}
    for fused in (True, False):
        _, state, step, data, _, _ = build_train_setup(
            cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
            steps_per_epoch=4, compute_dtype=torch.float32, fused_bn=fused,
            compression="bf16", seed=3, device="cuda")
        losses = []
        for i in range(3):
            state, metrics = step(state, data.batch_at(i))
            losses.append(float(metrics["loss"]))
        runs[fused] = (losses, state["params"])
    (lf, pf), (lu, pu) = runs[True], runs[False]
    rel = param_rel_norm(pf, pu)
    log(f"  fused {lf} vs unfused {lu}; param rel-norm diff {rel:.3g}")
    for a, b in zip(lf, lu):
        assert math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (lf, lu)
    assert rel < 1e-3, rel
    return {"fused_losses": lf, "unfused_losses": lu, "param_rel_norm": rel}


class PremadeSource:
    """A source whose batches are made before the run: the producer
    threads then only hand them over, so the step runs without them
    competing for the host."""

    def __init__(self, source, steps: int):
        self.batch = source.batch
        self.batches = [source.batch_at(i) for i in range(steps)]

    def batch_at(self, step: int):
        return self.batches[step]


def lars_recipe(steps: int, steps_per_epoch: int):
    """The ``lars_ls_poly`` recipe of the JAX package's
    ``examples/large_batch_sweep.py``: (optimizer config, label
    smoothing)."""
    from repro_torch.configs import OptimizerConfig
    return OptimizerConfig(kind="lars", schedule="poly", warmup_epochs=1.0,
                           total_epochs=max(1.0, steps / steps_per_epoch)), \
        0.1


def dp_main_path(torch, libs, cfg, steps: int, premade: bool = False,
                 lars: bool = False):
    """Main path 2: the paper's data-parallel step at world size 1 on
    NCCL, with every kernel of the slice on, through the same entry
    points a ``torchrun`` worker calls. ``premade`` feeds it batches
    made before the run (``PremadeSource``). ``lars`` makes it main path
    3: the ``lars_ls_poly`` recipe, whose update runs on the packed
    stream through the stream-LARS kernels."""
    import torch.distributed as dist

    from repro_torch.configs import InputConfig, OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup
    from repro_torch.training import Trainer, TrainerConfig

    workers = 4
    input_cfg = InputConfig(fused=True, num_workers=workers)
    opt_cfg, smoothing = (lars_recipe(steps, steps) if lars
                          else (OptimizerConfig(), 0.0))
    t0 = time.perf_counter()
    model, state, train_step, data, put_batch, _ = build_train_setup(
        cfg, global_batch=BATCH, seq_len=0, opt_cfg=opt_cfg,
        steps_per_epoch=steps, dp_mode="shardmap",
        compute_dtype=torch.bfloat16, use_fused_kernel=True,
        compression="bf16+bucketed", fused_bn=True, input_cfg=input_cfg,
        label_smoothing=smoothing, device="cuda")
    eval_step, val_data, finalize = build_eval_setup(
        model, cfg, global_batch=BATCH, seq_len=0, dp_mode="shardmap",
        input_cfg=input_cfg)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    n_leaves = len(state["params"])
    log(f"  setup {time.perf_counter() - t0:.1f}s: {n_leaves} parameter "
        f"leaves, {sum(p.numel() for p in state['params'].values())} "
        f"elements, backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}")
    p0 = {k: v.clone() for k, v in state["params"].items()}
    if premade:
        data = PremadeSource(data, steps)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1,
                         data_workers=workers)
    trainer = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                      val_data=val_data, finalize_state=finalize,
                      put_batch=put_batch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    result = trainer.run()
    torch.cuda.synchronize()
    launches = read_counts(libs)
    state = result.state

    losses = [h["loss"] for h in result.history]
    log(f"  losses {losses}")
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    check_state(torch, state, p0)
    sites, val = len(state["model_state"]), tcfg.val_batches
    assert sites == 53, sites
    want = {"bn_stats": sites * steps, "bn_bwd_sums": sites * steps,
            "bn_bwd_dx": sites * steps, "bn_apply": (steps + val) * sites,
            "hybrid_update": 0 if lars else n_leaves * steps,
            "seg_sq_partials": steps if lars else 0,
            "lars_update": steps if lars else 0,
            "cast_copy": 2 * steps,  # one pack, one unpack per step
            "input_train": steps, "input_eval": val}
    log(f"  launches {launches} (want {want}); batches staged "
        f"{put_batch.staged}")
    assert launches == want, (launches, want)
    ev = result.epoch_history[-1]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["top1"] <= 1.0, ev
    walls = [h["time"] for h in result.history[1:]]
    waits = [h["data_wait"] for h in result.history[1:]]
    med = statistics.median(walls)
    stats = {"steps": steps, "data_workers": workers,
             "median_step_ms": med * 1e3, "images_per_s": BATCH / med,
             "median_wall_ms": med * 1e3,
             "step_ms": [t * 1e3 for t in walls],
             "data_wait_ms": [t * 1e3 for t in waits],
             "median_data_wait_ms": statistics.median(waits) * 1e3,
             "first_step_ms": result.history[0]["time"] * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "eval": {k: ev[k] for k in ("top1", "loss")}}
    log(f"  median step {stats['median_step_ms']:.2f} ms, "
        f"{stats['images_per_s']:.1f} images/s (bf16, batch {BATCH}; host "
        f"wall time of the whole step, the wait for its batch included); "
        f"median data_wait {stats['median_data_wait_ms']:.2f} ms; peak "
        f"{stats['peak_mem_gib']:.2f} GiB; eval {stats['eval']}")
    return launches, stats, (train_step, state, data)


def dp_reference_phase(torch):
    """Reduced ResNet, f32 on the card, the DP step at world size 1 with
    every new kernel on (fused update, bucketed cast, fused input without
    augmentation) against the same step with them off (plain per-leaf
    update, per-leaf all-reduce, host normalize): three steps from one
    seed. cuDNN is held to deterministic algorithms for the comparison,
    and every kernel is bitwise equal to its plain version, so the two
    must be bitwise equal: losses and every parameter."""
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for on in (True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=on,
                compression="bf16+bucketed" if on else "bf16",
                input_cfg=InputConfig(fused=on, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            runs[on] = (losses, state["params"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lk, pk), (lp, pp) = runs[True], runs[False]
    rel = param_rel_norm(pk, pp)
    bitwise = lk == lp and all(torch.equal(pk[k], pp[k]) for k in pk)
    log(f"  kernels on {lk} vs off {lp}; param rel-norm diff {rel:.3g}; "
        f"bitwise {bitwise}")
    assert all(math.isfinite(v) for v in lk) and bitwise, (lk, lp, rel)
    return {"kernels_on_losses": lk, "kernels_off_losses": lp,
            "param_rel_norm": rel, "bitwise": bitwise}


def lars_reference_phase(torch):
    """Reduced ResNet, f32 on the card, cuDNN held to deterministic
    algorithms: the stream-LARS DP step with error feedback, three steps
    from one seed, twice with the kernels on (which must agree bit for
    bit) and once with the plain stream update. The kernels' segment
    norms are summed in another order than the plain version's, so the
    last two agree to rounding: losses within rtol 1e-5, parameters
    within a relative norm of 1e-5."""
    from repro_torch.configs import InputConfig, get_config, reduced_config
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    opt_cfg, smoothing = lars_recipe(3, 4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for on in (True, True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=opt_cfg,
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=on, compression="bf16+bucketed",
                error_feedback=True, label_smoothing=smoothing,
                input_cfg=InputConfig(fused=True, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            runs.append((losses, state))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l1, s1), (l2, s2), (lp, sp) = runs
    tensors = [(s1["params"], s2["params"]),
               (s1["ef_residual"], s2["ef_residual"]),
               ({"delta": s1["opt"]["delta"]}, {"delta": s2["opt"]["delta"]})]
    repeat = l1 == l2 and all(torch.equal(a[k], b[k]) for a, b in tensors
                              for k in a)
    rel = param_rel_norm(s1["params"], sp["params"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l1, lp))
    log(f"  kernels on {l1} (again: bitwise {repeat}) vs plain {lp}; loss "
        f"rel diff {loss_rel:.3g}, param rel-norm diff {rel:.3g}")
    assert all(math.isfinite(v) for v in l1) and repeat, (l1, l2)
    assert loss_rel <= 1e-5 and rel <= 1e-5, (l1, lp, rel)
    return {"kernels_on_losses": l1, "plain_losses": lp,
            "loss_rel_diff": loss_rel, "param_rel_norm": rel,
            "repeat_bitwise": repeat}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the per-shape kernel table")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path steps "
                         "(torch.profiler: device busy share, top ops)")
    ap.add_argument("--turns", type=int, default=0,
                    help="then run the main paths again in turns "
                         "(2, 2 pre-made, 1, 1, 2 pre-made, 2) this many "
                         "times, to compare their step times within one "
                         "run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.distributed import shutdown
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import fused_update as fu
    libs = (fb, fu, bo, fi)

    t_all = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build(SOURCES)
    log(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f}s")

    cfg = get_config("resnet50")
    t0 = time.perf_counter()
    log("[3] kernels vs plain versions at the batch-32 BN-site shapes")
    shape_rows = []
    totals, pair = kernel_phase(torch, fb, cfg, shape_rows)
    log(f"  per-step site pair (bf16): fwd {pair['fwd_ms']:.3f} ms vs "
        f"aten::native_batch_norm {pair['fwd_library_ms']:.3f} ms; bwd "
        f"{pair['bwd_ms']:.3f} ms vs its backward "
        f"{pair['bwd_library_ms']:.3f} ms "
        f"({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3b] fused update, wire cast and fused input vs plain versions")
    params_cpu = model_params(cfg)
    leaves = model_leaves(params_cpu)
    wd = OptimizerConfig().weight_decay
    new = {}
    new["hybrid_update"], total = update_phase(torch, leaves, wd)
    new["cast_copy"] = cast_phase(torch, total)
    new.update(input_phase(torch, cfg))
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3c] stream-LARS kernels vs plain versions and float64 sums")
    lars_totals, lars_cases = lars_phase(torch, params_cpu, wd)
    new.update(lars_totals)
    del params_cpu
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[4] main path 1: ResNet-50 full width, batch {BATCH}, bf16, fused "
        f"BN, {STEPS} steps + 1 eval batch")
    _, stats, live = main_path(torch, libs, cfg, STEPS)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    if args.profile:
        log("[4p] profile of the main path")
        stats["profile"] = profile_phase(torch, *live)

    t0 = time.perf_counter()
    log("[4b] reference: reduced ResNet f32, fused vs unfused on the card")
    ref = reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    try:
        t0 = time.perf_counter()
        log(f"[6] main path 2: the paper's DP step at world size 1 (NCCL), "
            f"ResNet-50 full width, batch {BATCH}, bf16, fused BN, "
            f"bf16+bucketed, fused update, fused input, 4 data workers, "
            f"{STEPS} steps + 1 eval batch")
        launches, stats2, live2 = dp_main_path(torch, libs, cfg, STEPS)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
        if args.profile:
            log("[6p] profile of main path 2")
            stats2["profile"] = profile_phase(torch, *live2)
        del live2

        t0 = time.perf_counter()
        log("[6b] reference: reduced ResNet f32, DP step, new kernels on "
            "vs off")
        ref2 = dp_reference_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        order = ("path2", "path2_premade", "path1", "path1",
                 "path2_premade", "path2")
        turns = {f"{k}_median_wall_ms": [] for k in order}
        if args.turns:
            log(f"[7] main paths in turns {order} x {args.turns}")
        for _ in range(args.turns):
            for which in order:
                if which == "path1":
                    st = main_path(torch, libs, cfg, STEPS)[1]
                else:
                    st = dp_main_path(torch, libs, cfg, STEPS,
                                      premade=which.endswith("premade"))[1]
                turns[f"{which}_median_wall_ms"].append(st["median_wall_ms"])
        if args.turns:
            log(f"  {turns}")

        t0 = time.perf_counter()
        log(f"[8] main path 3: stream-LARS on the DP step at world size 1 "
            f"(NCCL), ResNet-50 full width, batch {BATCH}, bf16, fused BN, "
            f"bf16+bucketed, lars_ls_poly, fused update, fused input, 4 "
            f"data workers, {STEPS} steps + 1 eval batch")
        launches3, stats3, live3 = dp_main_path(torch, libs, cfg, STEPS,
                                                lars=True)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
        if args.profile:
            log("[8p] profile of main path 3")
            stats3["profile"] = profile_phase(torch, *live3)
        del live3

        t0 = time.perf_counter()
        log("[8b] reference: reduced ResNet f32, stream-LARS DP step with "
            "error feedback, kernels on twice vs the plain stream update")
        ref3 = lars_reference_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutdown()

    by_path = {k: {"path2": launches[k], "path3": launches3[k]}
               for k in launches}
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "launches_by_path": by_path[k],
                "max_abs_err": totals[k]["max_abs_err"],
                "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
                "bound_ms": totals[k]["bound_ms"], "bound_by": "bytes",
                "library_ms": totals[k]["library_ms"]} for k in KERNELS]
    for k, (src, replaces) in {**NEW_KERNELS, **LARS_KERNELS}.items():
        t = new[k]
        kernels.append({
            "name": k, "route": "cuda", "source": CSRC + src,
            "replaces": replaces,
            "launches": (launches3 if k in LARS_KERNELS else launches)[k],
            "launches_by_path": by_path[k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    assert len(kernels) == 10, len(kernels)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"),
                  "w") as f:
            json.dump({"card": card, "shapes": shape_rows, "pair": pair,
                       "kernels": kernels, "new_kernels": new,
                       "main_path": stats, "main_path_2": stats2,
                       "main_path_3": stats3, "lars_cases": lars_cases,
                       "reference": ref, "reference_2": ref2,
                       "reference_3": ref3, "turns": turns}, f, indent=1)
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
