#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and is right there.

    python3 chip_smoke.py [--out DIR] [--profile] [--turns N]

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all started together);
  3. kernels: each of the four fused-BN kernels against its plain
     PyTorch version on the card (``bn_apply`` and ``bn_bwd_dx``
     bitwise, ``bn_bwd_dx`` also with non-zero mean / var cotangents and
     in given-stats mode, ``bn_stats`` the same bits on a second launch),
     at every BN-site shape of ResNet-50
     at batch 32 (stem 401,408 x 64 down to stage 3 1,568 x 2,048), in
     bf16 and f32, with kernel, plain and library times (CUDA events)
     and the HBM-bytes bound of each shape; the library yardsticks are
     ``torch.var_mean`` and ``torch.batch_norm_stats`` for ``bn_stats``,
     ``F.batch_norm`` (eval) for ``bn_apply``, the site pair against
     ``aten::native_batch_norm`` and its backward (also with
     ``threshold_backward`` in front at the ReLU sites), and at the
     sites with neither ReLU nor residual ``bn_bwd_sums`` / ``bn_bwd_dx``
     against ``torch.batch_norm_backward_reduce`` / ``_elemt`` (given
     the same sums); and whether ATen's division of a CUDA tensor by a
     Python float is a true division (logged);
  3b. the fused update, the wire cast and the fused input kernels against
     their plain versions, bitwise: ``hybrid_update`` for one leaf at
     every distinct ResNet-50 leaf size and the whole 25.56 M-element
     stream (decay none, scalar and a stream; a_sgd 0, 0.5 and 1), and
     over all 161 leaves and a one-element leaf in one launch (decay
     none and per leaf, gradients as views 0, 1 and 2 elements into one
     stream), ``cast_copy`` to bf16/f16 and back at the whole stream,
     odd lengths (7, 8k + 3) and views 4 and 8 bytes (f32) or 2 and 4
     bytes (half) into a buffer, ``input_train``/``input_eval`` at (32,
     224, 224, 3) with +-4 shifts and flips, bf16 and f32 out, and
     ``input_train`` at edge shapes ((2, 7, 5, 3), C = 1 and 4, an
     unaligned input) with shifts of +-W, +-(W+1) and +-3H; with kernel,
     plain, library and bound times per main-path step (the update also
     as one launch per leaf, the earlier design), and the host time of
     ``optimizer.update`` at main path 2's shapes against that of one
     launch per leaf;
  3c. the stream-LARS kernels against their plain versions:
     ``seg_sq_partials`` within rtol 1e-5 of a float64 sum of the same
     inputs and the same bits on a second launch, ``lars_update``
     bitwise, at ResNet-50's whole stream (162 segments), at the
     worker slices of an ``align=4`` plan for 2 and 4 workers, with zero
     gradients, and at edge cases (1 element, an empty segment,
     1-element segments, a segment across the kernels' chunks, a length
     not a multiple of 128); with kernel, plain and bound times, and
     ``hybrid_update`` timed with the per-element decay stream;
  3d. ``flash_attention`` and ``rmsnorm`` against their plain versions,
     bf16 and f32: flash at the serving path's prefill (8 x 1,024
     tokens, 32 query heads on 8 kv heads, Dh 64, causal), lengths 1 and
     1000, Sq != Sk, non-causal, a causal window of 256, groups 1, 4 and
     8, Dh 32, 96, 112 and 128, the 64-row tile edges (f32 rtol 1e-5 /
     atol 1e-6, bf16 within one bf16 ulp beyond that), and bf16 q, k, v
     that are views 8 bytes into their buffers, bitwise equal to their
     aligned copies' result; rmsnorm in both rounding orders (the Pallas
     kernel's and the JAX model's, which the serving path runs) at
     8,192 x 2,048 and 8 x 2,048 (a prefill's and a decode step's norm
     sites), odd row counts and d = 128 and 100 (f32 rtol 1e-6, bf16
     within two bf16 ulps: it rounds twice); with kernel, plain and
     library times (``F.scaled_dot_product_attention``, ``F.rms_norm``,
     every rmsnorm call given the same bf16 scale as the serving path's
     parameters are) and the bound of each case; an empty kernel timed
     the same way (the launch floor) at rmsnorm's decode grid;
  3e. gradients through the LM kernels' autograd Functions: rmsnorm in
     both orders and dtypes, flash at Dh 64 and 96 in both dtypes; every
     gradient (x and scale; q, k and v) present, finite, not all zero,
     and bitwise equal to the plain version's own autograd;
  4. main path 1 (slice 1, one device):
     ``repro_torch.launch.train.build_train_setup`` for the full-width
     ResNet-50 (stages 3,4,6,3, width 64, 1000 classes, 224
     px), global batch 32, bf16, fused BN, rmsprop_warmup + slow_start,
     bf16 wire cast, driven by the ``Trainer`` for one epoch of 8
     steps and one eval batch; launch counts must be 53 per
     train step (and 53 more per eval batch for bn_apply), and one more
     step under torch.profiler must run two ``bn_bwd_sums`` kernels and
     one ``bn_bwd_dx`` kernel per BN site (the same in 6 and 8);
  5. reference: the reduced ResNet in f32 on the card, fused kernels vs
     the unfused plain path, three steps from the same seed;
  6. main path 2, the paper's data-parallel step at world size 1 (NCCL):
     the same model and recipe with ``dp_mode="shardmap"``, the bucketed
     bf16 all-reduce, the fused update (one launch a step over every
     leaf), the fused input and a 4-worker feed, 8 steps and one eval
     batch after the BN all-reduce; every kernel's launch count is
     checked;
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
  9. main path 4, serving: ``repro_torch.launch.serve.serve`` of
     llama3.2-1b at full width (16 layers, d 2,048, 128,256-token
     vocabulary), 8 prompts of 1,024 tokens, one prefill and 31 greedy
     decode steps, bf16, chunked (flash) attention; the launch counts
     are checked (flash 16 per prefill and none per decode step, rmsnorm
     33 per forward), the first call against a warm one, peak device
     memory, and the prefill logits against the same prompts through
     the naive attention (relative norm within 5e-2);
  9b. reference: the reduced llama3.2-1b in f32 with the same weights on
     the card (kernels) and on the CPU (plain versions), prefill and 6
     decode steps, logits within rtol/atol 1e-4 and the same tokens.
  10. main path 2 with checkpoints, cuDNN deterministic: 6 steps with a
     save every 3 and one eval batch (the best checkpoint), then a fresh
     ``Trainer`` resumes from the step-3 checkpoint alone and runs to 6:
     params, ``delta``, ``m``, BN state and ``opt.step`` bitwise equal to
     the unbroken run; also 6 steps without checkpoints (every run's
     launch counts checked); the checkpoint's bytes, the ms the loop's
     thread blocks for the snapshot, the background write's ms, the
     restore's ms, and the step time with saves against without;
  10b. the sentinel on main path 2 (``sentinel=True``) with chaos
     ``nan_grad@4,ckpt_truncate@6,nan_grad@7-8`` and a save every 3:
     step 4 skipped with the state after it bitwise the state after
     step 3, steps 7 and 8 skipped and rolled back past the torn step-6
     checkpoint to step 3 (``corrupt_checkpoint_skipped``), the run
     completes, the event log on disk equals the one in memory, every
     call's launches counted; then 6 steps with the sentinel on and no
     fault (its cost beside phase 10's run without it) and the device
     time of its copy of the in-place state.
With ``--profile``, a few more steps of each main path run under
torch.profiler (device busy time and idle share, top host ops and
kernels), and one prefill and four decode steps of main path 4. With
``--turns N``, phase 7 runs the main paths again in turns, N times: main
path 2, main path 2 fed pre-made batches (its producer threads then only
hand them over), main path 1 twice, then the two variants of main path 2
in reverse, for their wall step times side by side. Then a ``{"kernels":
[...]}`` line (launches from main path 2 for its eight kernels, from
main path 3 for the two stream-LARS kernels, from main path 4 for
flash_attention and rmsnorm, whose times are per prefill;
``launches_by_path`` holds all three), the card's name and power limit,
and last the ``{"ok": true, "device": ...}`` line. ``--out DIR`` also
writes the per-shape kernel tables to ``DIR/chip_smoke_kernels.json``.

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
BF16_FLOPS_PER_S = 989e12  # bf16 dense on the tensor cores, same sheet
BATCH = 32  # the paper's per-GPU minibatch (32,768 over 1,024 GPUs)
STEPS = 8  # main-path train steps: the first is set-up, 7 are timed
# main path 4: llama3.2-1b serving 8 prompts of 1,024 tokens, then 31
# greedy decode steps (the first of the 32 tokens comes from the prefill)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 1024, 32
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
# the kernels of main path 4 (serving llama3.2-1b)
LM_KERNELS = {
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:29"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:20"),
}
SOURCES = ("fused_bn", "fused_update", "bucket_ops", "fused_input",
           "flash_attention", "rmsnorm", "launch_floor")
# flops per element of the hybrid update (decay 2, m 4, coef 4, delta 3,
# theta 2) and of the input transform (subtract, multiply)
UPDATE_FLOPS, INPUT_FLOPS = 15, 2
# per element: seg_sq_partials g + wd*p (2), two squares, two sums; the
# LARS update g + wd*p (2), mu1*d, t*g', their difference, eta*d', p + .
SEG_SQ_FLOPS, LARS_FLOPS = 6, 7
BUCKET_BYTES = 64 * 1024 * 1024
# the sums are held relative to the sum of the magnitudes they add
# (reduction order); bn_apply and bn_bwd_dx bitwise
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
        # mu, rstd, scale, s1, s2 (no mean / var cotangents on the path)
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
            "bwd_library_ms": 0.0, "bwd_library_same_ms": 0.0,
            # the sites with neither ReLU nor residual, where PyTorch's
            # sync-BN pieces compute what bn_bwd_sums / bn_bwd_dx do
            "plain_sites_bwd_sums_ms": 0.0, "backward_reduce_ms": 0.0,
            "plain_sites_bwd_dx_ms": 0.0, "backward_elemt_ms": 0.0}
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
            inv_m = 1.0 / rows
            dx_args = (dy, x, py, pmean, rstd, scale, p1, p2, None, None,
                       inv_m, relu, res)
            # the same site with mean / var cotangents, and given stats
            dx_cases = {"": dx_args,
                        " cotangents": dx_args[:8] + (
                            rnd(c, dt=torch.float32),
                            rnd(c, dt=torch.float32)) + dx_args[10:],
                        " given stats": dx_args[:6] + (None,) * 4
                        + dx_args[10:]}
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

            again = fb.bn_stats(x)  # one launch, merged by its last block
            if not (torch.equal(again[0], mean)
                    and torch.equal(again[1], var)):
                raise AssertionError(f"bn_stats {dname} rows={rows} C={c}: "
                                     f"not the same bits on a second launch")
            errs["bn_stats"] = max(
                sum_err("bn_stats mean", mean, pmean,
                        x32.abs().mean(0)),
                sum_err("bn_stats var", var, pvar,
                        (x32 - pmean).square().mean(0)))
            errs["bn_bwd_sums"] = max(
                sum_err("bn_bwd_sums S1", s1, p1, dym.abs().sum(0)),
                sum_err("bn_bwd_sums S2", s2, p2, (dym * xhat).abs().sum(0)))
            # bn_apply rounds each op once in the plain version's order
            if not torch.equal(y, py):
                raise AssertionError(
                    f"bn_apply {dname} rows={rows} C={c}: not bitwise equal"
                    f" to its plain version (max error "
                    f"{(y.float() - py.float()).abs().max().item():.3g})")
            errs["bn_apply"] = 0.0
            # so does bn_bwd_dx, its coefficients included
            for case, args in dx_cases.items():
                got = fb.bn_bwd_dx(*args)
                want = fb.PLAIN["bn_bwd_dx"](*args)
                for name, g, w in (("dx", got[0], want[0]),
                                   ("dres", got[1], want[1])):
                    if (g is None) != (w is None) or (
                            g is not None and not torch.equal(g, w)):
                        err = (g.float() - w.float()).abs().max().item() \
                            if g is not None and w is not None else None
                        raise AssertionError(
                            f"bn_bwd_dx {name}{case} {dname} rows={rows} "
                            f"C={c}: not bitwise equal to its plain version "
                            f"(max error {err})")
            errs["bn_bwd_dx"] = 0.0
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
                "bn_bwd_dx": (lambda: fb.bn_bwd_dx(*dx_args),
                              lambda: fb.PLAIN["bn_bwd_dx"](*dx_args), None),
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
            # bn_stats against the one call that computes its mean and
            # inverse std
            row["bn_stats"]["batch_norm_stats_ms"] = time_ms(
                torch, lambda: torch.batch_norm_stats(x, 1e-5))
            # the site pair against PyTorch's batch norm (training) forward
            # and its backward, one call each; the backward also with the
            # ReLU's threshold_backward in front at the ReLU sites (the
            # library's version of the same function: the residual's
            # gradient is the masked dy itself)
            _, smean, sinv = torch.ops.aten.native_batch_norm(
                x, lw, lb, None, None, True, 0.1, 1e-5)

            def bwd_same():
                g = (torch.ops.aten.threshold_backward(dy, py, 0)
                     if relu else dy)
                return torch.ops.aten.native_batch_norm_backward(
                    g, x, lw, None, None, smean, sinv, True, 1e-5,
                    [True, True, True])

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
                "bwd_library_same_ms": time_ms(torch, bwd_same),
            }
            if not relu and not res:
                # the sync-BN pieces: S1 / S2, then dx from the same sums
                # bn_bwd_dx is given (sum_dy_xmu = S2 / rstd) and the same
                # mean, inverse std and weight
                sdy, sdx = p1, p2 / rstd
                cnt = torch.full((1,), rows, dtype=torch.int32, device=dev)
                row["pair"].update(
                    backward_reduce_ms=time_ms(
                        torch, lambda: torch.batch_norm_backward_reduce(
                            dy, x, smean, sinv, scale, True, False, False)),
                    backward_elemt_ms=time_ms(
                        torch, lambda: torch.batch_norm_backward_elemt(
                            dy, x, pmean, rstd, scale, sdy, sdx, cnt)))
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
                totals["bn_stats"]["batch_norm_stats_ms"] = (
                    totals["bn_stats"].get("batch_norm_stats_ms", 0.0)
                    + count * row["bn_stats"]["batch_norm_stats_ms"])
                pr = dict(row["pair"])
                if "backward_reduce_ms" in pr:
                    pr["plain_sites_bwd_sums_ms"] = row["bn_bwd_sums"]["ms"]
                    pr["plain_sites_bwd_dx_ms"] = row["bn_bwd_dx"]["ms"]
                for f in pair:
                    pair[f] += count * pr.get(f, 0.0)
    return totals, pair


def division_check(torch, n: int = 1 << 20):
    """How ATen divides a CUDA f32 tensor by a Python float m (why
    ``bn_bwd_dx`` takes 1 / m from the host, as its plain version on
    the CPU does): the elements whose bits differ from t * f32(1 / m)
    and from the true division t / m (by a tensor of m), at m = 401,408
    (the stem's rows) and 1,568."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = torch.randn(n, generator=gen, device="cuda")
    out = {}
    for m in (401408, 1568):
        by_scalar = t / float(m)
        out[m] = {
            "differs_from_times_reciprocal": int(
                (by_scalar != t * (1.0 / m)).sum()),
            "differs_from_true_division": int(
                (by_scalar != t / torch.full_like(t, m)).sum()),
            "elements": n}
    return out


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


def leaf_tensors(torch, leaves, gen, offset: int = 0, extra=()):
    """Per-leaf p, d and m (each its own allocation, as parameters and
    state are) and g as views into one stream ``offset`` elements into
    its buffer (as ``unpack`` hands the gradients over), for leaves of
    the given sizes plus ``extra`` sizes."""
    dev = torch.device("cuda")
    sizes = [n for _, n, _ in leaves] + list(extra)
    buf = torch.randn(offset + sum(sizes), generator=gen, device=dev) * 1e-3
    gs, ps, ds, ms, lo = [], [], [], [], offset
    for n in sizes:
        gs.append(buf[lo:lo + n])
        lo += n
        ps.append(torch.randn(n, generator=gen, device=dev) * 0.05)
        ds.append(torch.randn(n, generator=gen, device=dev) * 1e-3)
        m = torch.rand(n, generator=gen, device=dev) * 1e-6
        m[:n // 4] = 0.0  # the state of the first step
        ms.append(m)
    return gs, ps, ds, ms


def update_phase(torch, leaves, wd: float):
    """``hybrid_update`` bitwise against its plain version: the one-leaf
    entry at every distinct leaf size and the whole stream (decay none,
    scalar and a stream), the multi-leaf entry over all leaves at once
    (decay none and per leaf, gradients as views 0, 1 and 2 elements
    into one stream, and a one-element leaf), each with a_sgd 0, 0.5 and
    1. Timed per main-path step as the one launch over every leaf, with
    the earlier design (one launch per leaf) beside it."""
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
    log(f"  hybrid_update one leaf bitwise at {len(sizes)} sizes (1 .. "
        f"{total}) x decay none/scalar/stream x a_sgd 0/0.5/1")
    per_leaf = [wd if dec else 0.0 for _, _, dec in leaves]
    for offset in (0, 1, 2):
        gs, ps, ds, ms = leaf_tensors(torch, leaves, gen, offset, extra=(1,))
        for dname, wds in (("none", [0.0] * len(gs)),
                           ("per leaf", per_leaf + [wd])):
            for a_sgd in (0.0, 0.5, 1.0):
                h = HybridHyper(eta=0.1, alpha_sgd=a_sgd)
                kern = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
                plain = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
                fu.reset_launch_counts()
                fu.fused_hybrid_update_leaves(gs, *kern, h, wds)
                launches = fu.LAUNCHES["hybrid_update"]
                assert launches == 1, launches
                for i, g in enumerate(gs):
                    fu.PLAIN["hybrid_update"](g, plain[0][i], plain[1][i],
                                              plain[2][i], h, wds[i])
                for what, ka, pa in zip(("theta", "delta", "m"), kern,
                                        plain):
                    for i, (a, b) in enumerate(zip(ka, pa)):
                        _bitwise(f"hybrid_update_leaves leaf {i} "
                                 f"g offset {offset} wd={dname} "
                                 f"a_sgd={a_sgd} {what}", a, b)
        del gs, ps, ds, ms, kern, plain
    log(f"  hybrid_update {len(leaves)} leaves + a 1-element leaf in one "
        f"launch, bitwise per leaf, g views 0/1/2 elements into one stream "
        f"x decay none/per leaf x a_sgd 0/0.5/1")
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)
    gs, ps, ds, ms = leaf_tensors(torch, leaves, gen)
    out = {"ms": time_ms(torch, lambda: fu.fused_hybrid_update_leaves(
               gs, ps, ds, ms, h, per_leaf)),
           "per_leaf_ms": 0.0, "plain_ms": 0.0, "library_ms": None,
           "max_abs_err": 0.0}
    del gs, ps, ds, ms
    nbytes = flops = 0
    for (n, dec), count in sorted(Counter((n, dec)
                                          for _, n, dec in leaves).items()):
        g, p, d, m = tensors(n)
        w = wd if dec else 0.0
        out["per_leaf_ms"] += count * time_ms(
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
        f"elements): {out['ms']:.3f} ms in one launch (one launch per leaf "
        f"{out['per_leaf_ms']:.3f}, plain {out['plain_ms']:.3f}, bound "
        f"{out['bound_ms']:.3f}); the whole stream as one leaf "
        f"{out['one_launch_stream_ms']:.3f} ms; with the decay stream "
        f"{out['wd_stream_ms']:.3f} ms (plain "
        f"{out['wd_stream_plain_ms']:.3f}, bound "
        f"{out['wd_stream_bound_ms']:.3f})")
    return out, total


def update_host_phase(torch, params_cpu, steps: int = 20):
    """Host time of one ``optimizer.update`` call (fused, f32 state) at
    main path 2's shapes: the parameters on the card, the gradients as
    views into one stream as ``unpack`` gives them. The earlier design,
    one ``fused_hybrid_update`` call per leaf as the optimizer's loop
    made them (the decay found from the name, the casts, the checks, a
    launch), is timed beside it. The host clock runs from a synchronized
    device to the call's return (the launches are asynchronous)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.rmsprop_warmup import decays

    dev = torch.device("cuda")
    cfg = OptimizerConfig()
    params = {k: v.to(dev).clone() for k, v in params_cpu.items()}
    stream = torch.randn(sum(p.numel() for p in params.values()),
                         device=dev) * 1e-3
    grads, lo = {}, 0
    for k, p in params.items():
        grads[k] = stream[lo:lo + p.numel()].view(p.shape)
        lo += p.numel()
    opt = make_optimizer(cfg, STEPS, BATCH, use_fused=True)
    state = opt.init(params)
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)

    def per_leaf():
        for k, p in params.items():
            d, m = state["delta"][k], state["m"][k]
            w = cfg.weight_decay if decays(k) else 0.0
            d32, m32 = d.float(), m.float()
            fu.fused_hybrid_update(grads[k].float().contiguous(), p, d32,
                                   m32, h, w)

    def host_ms(fn):
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def one_launch():
        opt.update(params, grads, state)

    out = {"one_launch_host_ms": [], "per_leaf_host_ms": []}
    for name, fn in (("one_launch", one_launch), ("per_leaf", per_leaf),
                     ("per_leaf", per_leaf), ("one_launch", one_launch)):
        out[f"{name}_host_ms"].append(host_ms(fn))
    fu.reset_launch_counts()
    opt.update(params, grads, state)
    out["launches_per_update"] = fu.LAUNCHES["hybrid_update"]
    assert out["launches_per_update"] == 1, out
    log(f"  optimizer.update host time ({len(params)} leaves, median of "
        f"{steps} calls, in turns): one launch {out['one_launch_host_ms']} "
        f"ms, one launch per leaf {out['per_leaf_host_ms']} ms")
    return out


def cast_phase(torch, total: int):
    """``cast_copy`` (``pack_cast`` / ``unpack_cast``) bitwise against
    ``Tensor.to`` at odd lengths and the whole stream, to bf16 and f16
    and back; timed as one pack and one unpack of the bf16 stream, the
    main path's casts per step."""
    from repro_torch.kernels import bucket_ops as bo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    lengths = (1, 7, 127, 8 * 16384 + 3, total)
    for n in lengths:
        for offset in (0, 1, 2):  # elements into the buffer
            buf = torch.randn(n + offset, generator=gen, device=dev) * 3
            x = buf[offset:]
            # overflow, underflow and subnormals of the half formats
            edge = torch.tensor([7e4, -1e5, 1e-8, -3e-6, 6.1e-5, 3e38, 1e-40,
                                 0.0], device=dev)[:n]
            x[:edge.numel()] = edge
            for wire in (bf16, torch.float16):
                what = f"n={n} offset={offset} {wire}"
                packed = bo.pack_cast(x, wire)
                _bitwise(f"pack_cast {what}", packed, x.to(wire))
                wbuf = torch.empty(n + offset, dtype=wire, device=dev)
                wbuf[offset:] = packed
                _bitwise(f"unpack_cast {what}", bo.unpack_cast(
                    wbuf[offset:]), packed.to(f32))
            del buf, x
    log(f"  cast_copy bitwise at n = {', '.join(map(str, lengths))}, each "
        f"0, 1 and 2 elements into its buffer, bf16 and f16, both ways")
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


# (shape, elements into the input's buffer) of input_train's edge cases:
# rows of 15 elements (no 16-byte access either side), C = 1 and C = 4
# (the run-time channel loop), rows of 24 (16-byte loads and stores; H 9
# leaves a block of one row), and the same with the input 4 bytes off
# alignment (element loads)
INPUT_EDGE_CASES = (((2, 7, 5, 3), 0), ((2, 7, 5, 1), 0), ((2, 7, 5, 4), 0),
                    ((3, 9, 8, 3), 0), ((3, 9, 8, 3), 1))
# (flip, dy(H), dx(W)) of the edge cases' samples, taken in turn
INPUT_EDGE_SHIFTS = (
    (1, lambda h: 3 * h, lambda w: w), (0, lambda h: -3 * h, lambda w: -w),
    (1, lambda h: h + 1, lambda w: w + 1),
    (0, lambda h: -(h + 1), lambda w: -(w + 1)),
    (1, lambda h: -3 * h, lambda w: w + 1),
    (0, lambda h: 3 * h + 2, lambda w: -(w + 1)),
    (1, lambda h: 0, lambda w: 0), (0, lambda h: 2, lambda w: -3))


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
    for shape, offset in INPUT_EDGE_CASES:
        b, h, w, c = shape
        rows = [[f, dy(h), dx(w), 0] for f, dy, dx in INPUT_EDGE_SHIFTS]
        buf = torch.randn(offset + b * h * w * c, generator=gen,
                          device=dev) * 50 + 120
        xe = buf[offset:].view(shape)
        me = torch.linspace(100.0, 130.0, c, device=dev)
        ie = 1.0 / torch.linspace(50.0, 60.0, c, device=dev)
        for lo in range(0, len(rows), b):
            te = torch.tensor((rows * b)[lo:lo + b], dtype=torch.int32,
                              device=dev)
            for dt in (torch.bfloat16, torch.float32, torch.float16):
                _bitwise(f"input_train {shape} offset {offset} table "
                         f"{te.tolist()} {dt}",
                         fi.fused_input_train(xe, te, me, ie, out_dtype=dt),
                         fi.PLAIN["input_train"](xe, te, me, ie, dt))
    log(f"  input_train bitwise at {[s for s, _ in INPUT_EDGE_CASES]} "
        f"(input offsets {[o for _, o in INPUT_EDGE_CASES]} elements), "
        f"shifts of +-W, +-(W+1), +-3H with and without flips, bf16 / f32 "
        f"/ f16 out")
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
    state, step_kernels = backward_kernel_check(torch, train_step, state,
                                                data, sites)
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
             "kernels_in_a_step": step_kernels,
             "eval": {k: ev[k] for k in ("top1", "loss")}}
    log(f"  median step {stats['median_step_ms']:.2f} ms, "
        f"{stats['images_per_s']:.1f} images/s (bf16, batch {BATCH}; "
        f"host wall time of the step, batch generation excluded); peak "
        f"{stats['peak_mem_gib']:.2f} GiB; eval {stats['eval']}")
    return launches, stats, (train_step, state, data)


# kernels per BN site per train step of the fused backward: bn_bwd_sums'
# two, bn_bwd_dx's one (the per-channel glue is inside its launch)
BWD_KERNELS = {"sums_partial": 1, "sums_merge": 1, "dx_kernel": 1}


def backward_kernel_check(torch, train_step, state, data, sites: int):
    """One more step under torch.profiler: the fused backward's kernels,
    counted by name, must be ``BWD_KERNELS`` per site. Returns the new
    state and the step's kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = data.batch_at(2000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = train_step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    got = {k: sum(e.count for e in kernels if k in e.key)
           for k in BWD_KERNELS}
    want = {k: v * sites for k, v in BWD_KERNELS.items()}
    total = sum(e.count for e in kernels)
    log(f"  one more step under torch.profiler: {total} kernels, "
        f"backward BN kernels {got} (want {want})")
    assert got == want, (got, want)
    return state, total


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


DP_WORKERS = 4  # producer threads of the DP main paths


def dp_setup(torch, cfg, steps: int, lars: bool = False,
             sentinel: bool = False):
    """Main path 2's pieces (main path 3's with ``lars``), through the
    entry points a ``torchrun`` worker calls: (state, train_step, data,
    put_batch, state_shardings, (eval_step, val_data, finalize))."""
    from repro_torch.configs import InputConfig, OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup

    input_cfg = InputConfig(fused=True, num_workers=DP_WORKERS)
    opt_cfg, smoothing = (lars_recipe(steps, steps) if lars
                          else (OptimizerConfig(), 0.0))
    model, state, train_step, data, put_batch, shardings = \
        build_train_setup(
            cfg, global_batch=BATCH, seq_len=0, opt_cfg=opt_cfg,
            steps_per_epoch=steps, dp_mode="shardmap",
            compute_dtype=torch.bfloat16, use_fused_kernel=True,
            compression="bf16+bucketed", fused_bn=True, input_cfg=input_cfg,
            label_smoothing=smoothing, sentinel=sentinel, device="cuda")
    evals = build_eval_setup(model, cfg, global_batch=BATCH, seq_len=0,
                             dp_mode="shardmap", input_cfg=input_cfg)
    return state, train_step, data, put_batch, shardings, evals


def dp_want(calls: int, evals: int, n_leaves: int, lars: bool = False):
    """Each kernel's launches on the DP main paths for ``calls`` train
    steps and ``evals`` eval batches of ResNet-50's 53 BN sites."""
    from repro_torch.kernels.fused_update import MAX_LEAVES
    sites = 53
    return {"bn_stats": sites * calls, "bn_bwd_sums": sites * calls,
            "bn_bwd_dx": sites * calls, "bn_apply": (calls + evals) * sites,
            "hybrid_update": 0 if lars else calls * -(-n_leaves
                                                      // MAX_LEAVES),
            "seg_sq_partials": calls if lars else 0,
            "lars_update": calls if lars else 0,
            "cast_copy": 2 * calls,  # one pack, one unpack per step
            "input_train": calls, "input_eval": evals,
            "flash_attention": 0, "rmsnorm": 0}


def dp_main_path(torch, libs, cfg, steps: int, premade: bool = False,
                 lars: bool = False):
    """Main path 2: the paper's data-parallel step at world size 1 on
    NCCL, with every kernel of the slice on, through the same entry
    points a ``torchrun`` worker calls. ``premade`` feeds it batches
    made before the run (``PremadeSource``). ``lars`` makes it main path
    3: the ``lars_ls_poly`` recipe, whose update runs on the packed
    stream through the stream-LARS kernels."""
    import torch.distributed as dist

    from repro_torch.training import Trainer, TrainerConfig

    workers = DP_WORKERS
    t0 = time.perf_counter()
    state, train_step, data, put_batch, _, (eval_step, val_data, finalize) \
        = dp_setup(torch, cfg, steps, lars=lars)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    n_leaves = len(state["params"])
    log(f"  setup {time.perf_counter() - t0:.1f}s: {n_leaves} parameter "
        f"leaves, {sum(p.numel() for p in state['params'].values())} "
        f"elements, backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}")
    p0 = {k: v.clone() for k, v in state["params"].items()}
    source = data
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
    want = dp_want(steps, val, n_leaves, lars)
    log(f"  launches {launches} (want {want}); batches staged "
        f"{put_batch.staged}")
    assert launches == want, (launches, want)
    state, step_kernels = backward_kernel_check(torch, train_step, state,
                                                source, sites)
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
             "kernels_in_a_step": step_kernels,
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


CKPT_STEPS, CKPT_EVERY = 6, 3  # phase 10: six steps, a save every three
# phase 10b: a NaN batch at step 4 (skipped), the newest checkpoint torn
# after the save at step 6, then NaN batches at 7 and 8: two bad steps in
# a row roll back, past the torn step-6 checkpoint, to step 3
SENTINEL_STEPS, SENTINEL_CHAOS = 9, "nan_grad@4,ckpt_truncate@6,nan_grad@7-8"


def train_state_bits(state):
    """Clones of every tensor of a main-path-2 train state (params,
    ``delta``, ``m``, BN state) and the optimizer's ``step``."""
    out = {"opt/step": state["opt"]["step"]}
    for k, t in state["params"].items():
        out["params/" + k] = t.clone()
    for f in ("delta", "m"):
        for k, t in state["opt"][f].items():
            out[f"{f}/{k}"] = t.clone()
    for site, rec in state["model_state"].items():
        for k, t in rec.items():
            out[f"bn/{site}/{k}"] = t.clone()
    return out


def bits_differ(torch, a, b):
    """Names of the entries of two ``train_state_bits`` that are not
    bitwise equal."""
    assert a.keys() == b.keys()
    return [k for k in a if not (a[k] == b[k] if k == "opt/step"
                                 else torch.equal(a[k], b[k]))]


def dp_trainer(torch, libs, cfg, steps: int, sentinel: bool = False,
               train_step=None, **kw):
    """A ``Trainer`` over ``steps`` steps of main path 2 and one eval
    batch (``kw`` adds checkpointing, resilience or chaos), run with the
    kernel counts set to 0 just before: (result, run wall s, launches,
    state_shardings, the parameter count)."""
    from repro_torch.training import Trainer, TrainerConfig

    ckpt = {k: kw.pop(k) for k in ("checkpoint_dir", "checkpoint_every")
            if k in kw}
    state, step, data, put_batch, shardings, (ev, vd, fin) = dp_setup(
        torch, cfg, steps, sentinel=sentinel)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1,
                         data_workers=DP_WORKERS, **ckpt)
    trainer = Trainer(train_step(step) if train_step else step, state, data,
                      tcfg, eval_step=ev, val_data=vd, finalize_state=fin,
                      put_batch=put_batch, state_shardings=shardings,
                      metadata={"arch": "resnet50",
                                "optimizer": "rmsprop_warmup",
                                "opt_layout": "tree"}, **kw)
    torch.cuda.synchronize()
    reset_counts(libs)
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, wall, read_counts(libs), shardings, len(state["params"])


def median_step_ms(result) -> float:
    return statistics.median(h["time"] for h in result.history[1:]) * 1e3


def ckpt_phase(torch, libs, cfg):
    """Phase 10: main path 2 with checkpoints, cuDNN held to
    deterministic algorithms. Six steps with a save every three and one
    eval batch (which also writes the best checkpoint); a fresh
    ``Trainer`` then resumes from the step-3 checkpoint alone and runs
    to 6: params, ``delta``, ``m``, BN state and ``opt.step`` bitwise
    equal to the unbroken run. Also six steps with no checkpointing
    (each run's launch counts checked), and the costs of a save and a
    restore of the final state."""
    import shutil
    import tempfile

    from repro_torch import interop
    from repro_torch.checkpoint import (AsyncCheckpointer,
                                        list_checkpoints, restore)
    from repro_torch.checkpoint.checkpointer import ARRAYS, BEST_DIR

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        unbroken = os.path.join(root, "unbroken")
        runs = {}
        for name, kw in (("no_ckpt", {}),
                         ("ckpt", dict(checkpoint_dir=unbroken,
                                       checkpoint_every=CKPT_EVERY))):
            res, wall, launches, shardings, n_leaves = dp_trainer(
                torch, libs, cfg, CKPT_STEPS, **kw)
            want = dp_want(CKPT_STEPS, 1, n_leaves)
            assert launches == want, (name, launches, want)
            runs[name] = {"median_step_ms": median_step_ms(res),
                          "run_ms_per_step": wall / CKPT_STEPS * 1e3,
                          "step_ms": [h["time"] * 1e3 for h in res.history],
                          "losses": [h["loss"] for h in res.history]}
            if name == "ckpt":
                full = train_state_bits(res.state)
                final = res.state
            else:
                del res
        steps = list_checkpoints(unbroken)
        best = list_checkpoints(os.path.join(unbroken, BEST_DIR))
        assert steps == [CKPT_EVERY, CKPT_STEPS] and best == [CKPT_STEPS], \
            (steps, best)
        first = f"step_{CKPT_EVERY:010d}"
        resumed_dir = os.path.join(root, "resumed")
        shutil.copytree(os.path.join(unbroken, first),
                        os.path.join(resumed_dir, first))
        res, _, launches, _, n_leaves = dp_trainer(
            torch, libs, cfg, CKPT_STEPS, checkpoint_dir=resumed_dir,
            checkpoint_every=CKPT_EVERY)
        want = dp_want(CKPT_STEPS - CKPT_EVERY, 1, n_leaves)
        assert res.resumed_from == CKPT_EVERY, res.resumed_from
        assert launches == want, ("resumed", launches, want)
        differ = bits_differ(torch, full, train_state_bits(res.state))
        log(f"  resumed from step {res.resumed_from}: losses "
            f"{[h['loss'] for h in res.history]} vs unbroken "
            f"{runs['ckpt']['losses'][CKPT_EVERY:]}; {len(full)} entries, "
            f"{len(differ)} not bitwise equal {differ[:5]}")
        assert not differ, differ
        del res
        # the costs of one save (snapshot on the loop's thread, then the
        # background write) and one restore, at the final state
        nbytes = os.path.getsize(os.path.join(unbroken, first, ARRAYS))
        timing = os.path.join(root, "timing")
        ck = AsyncCheckpointer(timing, keep=1)
        snap, write, load = [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(100 + i, interop.train_state_to_jax(final, shardings))
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            arrays, _ = restore(timing)
            interop.train_state_from_jax(arrays, final, shardings)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            snap.append((t1 - t0) * 1e3)
            write.append((t2 - t1) * 1e3)
            load.append((t3 - t2) * 1e3)
        assert not bits_differ(torch, full, train_state_bits(final))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        shutil.rmtree(root, ignore_errors=True)
    out = {"checkpoint_bytes": nbytes, "entries": len(full),
           "snapshot_ms": snap, "write_ms": write, "restore_ms": load,
           "runs": runs, "resume_bitwise": True}
    log(f"  checkpoint {nbytes} bytes; snapshot (loop thread blocked) "
        f"{statistics.median(snap):.1f} ms, background write "
        f"{statistics.median(write):.1f} ms, restore "
        f"{statistics.median(load):.1f} ms (medians of 3: {snap}, {write}, "
        f"{load})")
    log(f"  median step {runs['ckpt']['median_step_ms']:.2f} ms with a save "
        f"every {CKPT_EVERY} steps vs {runs['no_ckpt']['median_step_ms']:.2f}"
        f" ms without; whole run {runs['ckpt']['run_ms_per_step']:.1f} vs "
        f"{runs['no_ckpt']['run_ms_per_step']:.1f} ms a step (set-up step "
        f"and eval included)")
    return out


def sentinel_phase(torch, libs, cfg):
    """Phase 10b: main path 2 with the sentinel (``--sentinel``), chaos
    ``SENTINEL_CHAOS`` and a save every three steps. Step 4's NaN batch
    is skipped (the state after it bitwise the state after step 3, read
    by a probe around the step); the NaN batches at 7 and 8 roll back,
    past the checkpoint torn after the save at 6, to step 3; the run
    completes, every call's kernels counted. Then six steps with the
    sentinel on and no fault, for its cost beside phase 10's run without
    it, and the device time of its state copy."""
    import json
    import shutil
    import tempfile

    from repro_torch.resilience import ResilienceConfig, parse_chaos
    from repro_torch.resilience.sentinel import _in_place_tensors

    root = tempfile.mkdtemp(prefix="chip_smoke_sentinel_")
    calls, probe = [], {}

    def probed(step):
        def run(state, batch, controls):
            new, metrics = step(state, batch, controls)
            i = len(calls)
            calls.append(bool(metrics["bad_step"]))
            if i in (3, 4):
                probe[i] = train_state_bits(new)
            return new, metrics
        return run

    try:
        log_path = os.path.join(root, "events.jsonl")
        res, _, launches, _, n_leaves = dp_trainer(
            torch, libs, cfg, SENTINEL_STEPS, sentinel=True,
            train_step=probed, checkpoint_dir=os.path.join(root, "ck"),
            checkpoint_every=CKPT_EVERY,
            resilience=ResilienceConfig(max_consecutive_bad=2,
                                        event_log=log_path),
            chaos=parse_chaos(SENTINEL_CHAOS))
        kinds = [r["kind"] for r in res.events]
        with open(log_path) as f:
            on_disk = [json.loads(line)["kind"] for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  events {kinds}")
    log(f"  bad steps by call {calls}")
    assert on_disk == kinds, (on_disk, kinds)
    skipped = [r["step"] for r in res.events if r["kind"] == "step_skipped"]
    rollbacks = [(r["from_step"], r["to_step"]) for r in res.events
                 if r["kind"] == "rollback"]
    corrupt = [r["step"] for r in res.events
               if r["kind"] == "corrupt_checkpoint_skipped"]
    assert calls[4] and not calls[3], calls
    differ = bits_differ(torch, probe[3], probe[4])
    assert not differ, ("the skipped step changed the state", differ)
    assert skipped == [4, 7, 8] and rollbacks == [(8, CKPT_EVERY)] \
        and corrupt == [6], (skipped, rollbacks, corrupt)
    # 9 steps, then steps 3..8 again after the rollback
    assert len(calls) == SENTINEL_STEPS + SENTINEL_STEPS - CKPT_EVERY, calls
    want = dp_want(len(calls), 1, n_leaves)
    assert launches == want, (launches, want)
    losses = [h["loss"] for h in res.history]
    assert res.history[-1]["step"] == SENTINEL_STEPS - 1 and all(
        math.isfinite(v) for v in losses), res.history
    state = res.state
    del res
    # the sentinel's own cost: its copy of the in-place state, timed on
    # the device, and six steps with the sentinel on and no fault
    live = _in_place_tensors(state)
    backup = [torch.empty_like(t) for t in live]
    copy_ms = time_eager_ms(torch,
                            lambda: torch._foreach_copy_(backup, live))
    copy_bytes = 2 * sum(t.numel() * t.element_size() for t in live)
    del state, live, backup
    res, wall, launches, _, n_leaves = dp_trainer(
        torch, libs, cfg, CKPT_STEPS, sentinel=True,
        resilience=ResilienceConfig())
    assert launches == dp_want(CKPT_STEPS, 1, n_leaves), launches
    out = {"events": kinds, "bad_by_call": calls, "skip_bitwise": True,
           "rollbacks": rollbacks, "corrupt_skipped": corrupt,
           "losses": losses, "copy_ms": copy_ms, "copy_bytes": copy_bytes,
           "copy_bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3,
           "sentinel_median_step_ms": median_step_ms(res),
           "sentinel_run_ms_per_step": wall / CKPT_STEPS * 1e3}
    log(f"  sentinel copy of the in-place state {copy_ms:.3f} ms on the "
        f"device ({copy_bytes} bytes moved, bound "
        f"{out['copy_bound_ms']:.3f} ms); median step with the sentinel on "
        f"{out['sentinel_median_step_ms']:.2f} ms, whole run "
        f"{out['sentinel_run_ms_per_step']:.1f} ms a step")
    return out


# (B, Sq, Sk, Hq, Hkv, Dh, causal, window) of phase 3d: the serving
# path's prefill first, then lengths 1 and 1000, Sq != Sk, non-causal, a
# causal window of 256, groups 1, 4 and 8, Dh 32 and 128, the 64-row
# tile edges (one row past a tile, one short of it, a single key), and Dh
# 96 and 112 (phi-3-vision's and zamba2-7b's heads: MHA, 32 kv heads),
# each with a tile-edge case of its own
FLASH_CASES = [
    (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 64, True, None),
    (2, 1, 1, 8, 8, 64, True, None),
    (2, 1000, 1000, 32, 8, 64, True, None),
    (2, 300, 1000, 8, 2, 64, True, None),
    (2, 1000, 300, 8, 2, 64, False, None),
    (2, 1024, 1024, 8, 8, 64, False, None),
    (2, 1000, 1000, 16, 4, 64, True, 256),
    (1, 777, 777, 8, 1, 128, True, None),
    (2, 513, 513, 8, 2, 32, True, None),
    (1, 65, 63, 8, 8, 64, True, None),
    (2, 129, 129, 32, 8, 128, True, None),
    (1, 64, 1, 4, 1, 32, False, None),
    (1, 1000, 1000, 32, 32, 96, True, None),
    (1, 1000, 1000, 32, 32, 112, True, None),
    (1, 65, 63, 8, 8, 96, True, None),
    (2, 129, 129, 8, 4, 112, False, None),
]
# the bf16 case whose q, k and v are views 8 bytes into their buffers
MISALIGNED_CASE = (2, 300, 300, 8, 2, 64, True, None)
# (rows, d) of phase 3d: a prefill's and a decode step's norm sites, odd
# row counts, the reduced config's d = 128, a d with no 16-byte loads
RMSNORM_CASES = [(SERVE_BATCH * SERVE_PROMPT, 2048), (SERVE_BATCH, 2048),
                 (333, 2048), (1001, 128), (5, 100)]
# kernel vs plain: flash f32 rtol 1e-5 / atol 1e-6 (its sums run in
# another order than the plain full softmax), RMSNorm f32 rtol 1e-6 (the
# row sum's order moves inv by an ulp); in bf16, beyond those, flash
# within one bf16 ulp (one rounding of the f32 result) and RMSNorm within
# two (it rounds twice, x * inv and then the product with the scale: a
# flip of the first rounding moves the second product by up to ~2 ulps)
LM_TOL = {"flash_attention": dict(rtol=1e-5, atol=1e-6),
          "rmsnorm": dict(rtol=1e-6, atol=0.0)}
BF16_ULPS = {"flash_attention": 1, "rmsnorm": 2}
# flash vs naive attention, bf16 prefill logits at full width, relative
# norm: the naive path rounds scores and probabilities to bf16 (2^-8
# each) where the flash kernel keeps them in f32, and 16 layers of
# random weights carry that drift to the logits (~2e-2, PERF.md §6); the
# bound leaves room above it
NAIVE_REL_TOL = 5e-2


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (q, k) pairs the masks keep, positions from 0 on both sides."""
    import numpy as np
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= k <= q
    if window is not None:
        keep &= q - k < window
    return int(keep.sum())


def flash_bound(case, esize: int):
    """(bound ms at the bf16 tensor-core peak, the same at the f32
    CUDA-core peak, what bounds the first): the larger of q, k, v and out
    moved once over the HBM rate and 4 * Dh flops per live (q, k) pair
    per batch row and query head."""
    b, sq, sk, hq, hkv, dh, causal, window = case
    nbytes = esize * b * dh * (2 * sq * hq + 2 * sk * hkv)
    flops = 4 * b * hq * dh * live_pairs(sq, sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_bf16, t_f32 = flops / BF16_FLOPS_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_bf16) * 1e3, max(t_bytes, t_f32) * 1e3,
            "bytes" if t_bytes >= t_bf16 else "operations", flops)


def _bf16_ulp_check(torch, name, got, want, ulps, rtol, atol) -> float:
    """Raise unless |got - want| <= ``ulps`` bf16 ulps of want + atol +
    rtol * |want| everywhere; returns the largest |got - want|."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (got - want).abs()
    if bool((err > ulps * ulp + atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: beyond {ulps} bf16 ulp, max error "
                             f"{err.max().item():.3g}")
    return err.max().item()


def lm_kernel_phase(torch):
    """Phase 3d: ``flash_attention`` and ``rmsnorm`` against their plain
    versions at every case, bf16 and f32, each case timed (kernel, plain,
    library) with its bound. Returns per-prefill totals at the serving
    path's shapes in bf16 (16 flash launches at the first case, 33
    rmsnorm launches at the first) and every case's record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    dtypes = (("bf16", torch.bfloat16), ("f32", torch.float32))
    records = {"flash_attention": [], "rmsnorm": []}
    for case in FLASH_CASES:
        b, sq, sk, hq, hkv, dh, causal, window = case
        for dname, dt in dtypes:
            q, k, v = (torch.randn(b, s, h, dh, generator=gen, device=dev)
                       .to(dt) for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.PLAIN["flash_attention"](q, k, v, causal, window)
            torch.cuda.synchronize()
            name = f"flash_attention {dname} {case}"
            tol, ulps = LM_TOL["flash_attention"], BF16_ULPS["flash_attention"]
            if dname == "f32":
                torch.testing.assert_close(got, want, **tol, msg=lambda m: (
                    f"{name}: {m}"))
                err = (got - want).abs().max().item()
            else:
                err = _bf16_ulp_check(torch, name, got, want, ulps, **tol)
            bound_ms, f32_bound_ms, bound_by, flops = flash_bound(
                case, q.element_size())
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec = {"case": list(case), "dtype": dname, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: fa.flash_attention(
                       q, k, v, causal=causal, window=window)),
                   "plain_ms": time_ms(torch, lambda: fa.PLAIN[
                       "flash_attention"](q, k, v, causal, window)),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
                   "flops": flops}
            if window is None:  # SDPA takes a window only as a mask
                rec["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True))
            records["flash_attention"].append(rec)
            lib = rec["library_ms"]
            log(f"  flash {dname:4s} {case}: {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.4f}, sdpa "
                f"{'-' if lib is None else f'{lib:.4f}'}, bound "
                f"{bound_ms:.4f} bf16 tc / {f32_bound_ms:.4f} f32), max err "
                f"{err:.3g}")
            del q, k, v, got, want
    records["flash_misaligned"] = misaligned_flash(torch, fa, gen)
    for rows, d in RMSNORM_CASES:
        for dname, dt in dtypes:
            x = (torch.randn(rows, d, generator=gen, device=dev) * 2
                 + 0.3).to(dt)
            # the serving path's scale is a parameter in x's dtype already
            st = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dt)
            tol, ulps = LM_TOL["rmsnorm"], BF16_ULPS["rmsnorm"]
            err = 0.0
            for order, round_inv in (("pallas", False), ("model", True)):
                got = rn.rmsnorm(x, st, round_inv=round_inv)
                want = rn.PLAIN["rmsnorm"](x, st, 1e-5, round_inv)
                torch.cuda.synchronize()
                name = f"rmsnorm {dname} rows={rows} d={d} {order} order"
                if dname == "f32":
                    torch.testing.assert_close(got, want, **tol,
                                               msg=lambda m: f"{name}: {m}")
                    e = (got - want).abs().max().item()
                else:
                    e = _bf16_ulp_check(torch, name, got, want, ulps, **tol)
                err = max(err, e)
            es = x.element_size()
            bound_ms, bound_by = bound(es * (2 * rows * d + d), 4 * rows * d)
            # timed in the model's order, the one the serving path runs;
            # kernel, plain version and F.rms_norm take the same scale
            rec = {"rows": rows, "d": d, "dtype": dname, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: rn.rmsnorm(
                       x, st, round_inv=True)),
                   "pallas_order_ms": time_ms(torch, lambda: rn.rmsnorm(
                       x, st)),
                   "plain_ms": time_ms(torch, lambda: rn.PLAIN["rmsnorm"](
                       x, st, 1e-5, True)),
                   "library_ms": time_ms(torch, lambda: F.rms_norm(
                       x, (d,), st, 1e-5)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            records["rmsnorm"].append(rec)
            log(f"  rmsnorm {dname:4s} {rows:5d} x {d:4d}: {rec['ms']:.4f} "
                f"ms (Pallas order {rec['pallas_order_ms']:.4f}, plain "
                f"{rec['plain_ms']:.4f}, F.rms_norm "
                f"{rec['library_ms']:.4f}, bound {bound_ms:.4f}), max err "
                f"{err:.3g} (both orders)")
    n_layers = 16  # llama3.2-1b
    per_prefill = {"flash_attention": n_layers, "rmsnorm": 2 * n_layers + 1}
    totals = {}
    for k in ("flash_attention", "rmsnorm"):
        recs = records[k]
        first = next(r for r in recs if r["dtype"] == "bf16")
        n = per_prefill[k]
        totals[k] = {f: (None if first[f] is None else n * first[f])
                     for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
        totals[k].update(
            max_abs_err=max(r["max_abs_err"] for r in recs),
            bound_by=first["bound_by"], ms_per_launch=first["ms"],
            unit=f"per prefill ({n} launches at the first case, bf16)")
    dec = next(r for r in records["rmsnorm"]
               if r["dtype"] == "bf16" and r["rows"] == SERVE_BATCH)
    totals["rmsnorm"]["decode_launch_ms"] = dec["ms"]
    totals["rmsnorm"]["decode_step_ms"] = per_prefill["rmsnorm"] * dec["ms"]
    totals["rmsnorm"]["decode_step_bound_ms"] = \
        per_prefill["rmsnorm"] * dec["bound_ms"]
    first = records["flash_attention"][0]
    totals["flash_attention"]["f32_bound_ms"] = \
        n_layers * first["f32_bound_ms"]
    return totals, records


def launch_floor_phase(torch):
    """An empty kernel (``csrc/launch_floor.cu``) timed by the same
    CUDA-graph replay as the kernels: the least time any launch takes.
    At rmsnorm's decode grid (one 128-thread block per row of a decode
    step) and at one warp."""
    from repro_torch.kernels._launch import I32, P, Library, stream
    lib = Library("launch_floor", {"launch_floor": [I32, I32, P]})
    out = {}
    for name, blocks, threads in (("decode_grid", SERVE_BATCH, 128),
                                  ("one_warp", 1, 32)):
        out[f"{name}_ms"] = time_ms(torch, lambda: lib.launch(
            "launch_floor", blocks, threads, stream()))
    log(f"  empty kernel: {out['decode_grid_ms'] * 1e3:.2f} us at "
        f"{SERVE_BATCH} x 128 threads, {out['one_warp_ms'] * 1e3:.2f} us "
        f"at 1 x 32")
    return out


def misaligned_flash(torch, fa, gen):
    """bf16 q, k and v as views 8 bytes into their buffers (their rows do
    not start 16-byte aligned): the wrapper copies them and launches the
    same kernel, so the result must equal that of aligned copies bit for
    bit, and the plain version's within the bf16 check."""
    b, sq, sk, hq, hkv, dh, causal, window = MISALIGNED_CASE
    views = []
    for s, h in ((sq, hq), (sk, hkv), (sk, hkv)):
        n = b * s * h * dh
        buf = torch.randn(n + 4, generator=gen, device="cuda").bfloat16()
        views.append(buf[4:].view(b, s, h, dh))
    assert not any(fa._rows_aligned(t) for t in views)
    copies = [t.clone(memory_format=torch.contiguous_format) for t in views]
    got = fa.flash_attention(*views, causal=causal, window=window)
    want = fa.flash_attention(*copies, causal=causal, window=window)
    plain = fa.PLAIN["flash_attention"](*views, causal, window)
    torch.cuda.synchronize()
    _bitwise(f"flash_attention misaligned {MISALIGNED_CASE} vs aligned "
             f"copies", got, want)
    err = _bf16_ulp_check(torch, "flash_attention misaligned", got, plain,
                          BF16_ULPS["flash_attention"],
                          **LM_TOL["flash_attention"])
    rec = {"case": list(MISALIGNED_CASE), "dtype": "bf16",
           "bitwise_vs_aligned": True, "max_abs_err": err,
           "ms": time_ms(torch, lambda: fa.flash_attention(
               *views, causal=causal, window=window)),
           "aligned_ms": time_ms(torch, lambda: fa.flash_attention(
               *copies, causal=causal, window=window))}
    log(f"  flash bf16 {MISALIGNED_CASE} as views 8 bytes into their "
        f"buffers: bitwise equal to aligned copies, max err vs plain "
        f"{err:.3g}; {rec['ms']:.4f} ms with the copies (aligned "
        f"{rec['aligned_ms']:.4f})")
    return rec


def grad_phase(torch):
    """Phase 3e: ``backward`` through the autograd Functions of
    ``rmsnorm`` (both rounding orders, both dtypes) and
    ``flash_attention`` (Dh 64 and 96, both dtypes). Each gradient must
    exist, be finite and not all zero, and equal the plain version's own
    autograd gradient bit for bit (the Function's backward is that
    recompute)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = []
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x = (torch.randn(333, 2048, generator=gen, device=dev) * 2).to(dt)
        scale = 1 + 0.1 * torch.randn(2048, generator=gen, device=dev)
        for round_inv in (False, True):
            cases.append((
                f"rmsnorm {dname} round_inv={round_inv}", (x, scale),
                lambda a, b, r=round_inv: rn.rmsnorm(a, b, round_inv=r),
                lambda a, b, r=round_inv: rn.PLAIN["rmsnorm"](a, b, 1e-5, r)))
        for dh in (64, 96):
            qkv = tuple(torch.randn(2, 300, h, dh, generator=gen, device=dev)
                        .to(dt) for h in (8, 2, 2))
            cases.append((
                f"flash_attention {dname} Dh {dh}", qkv,
                lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
                lambda a, b, c: fa.PLAIN["flash_attention"](a, b, c, True,
                                                            None)))
    out = {}
    for name, inputs, fn, plain in cases:
        grads = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            y = f(*leaves)
            g = torch.Generator(device=dev).manual_seed(7)
            y.backward(torch.randn(y.shape, generator=g, device=dev)
                       .to(y.dtype))
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*grads)):
            what = f"{name} grad of input {i}"
            if a is None or not bool(torch.isfinite(a).all()) \
                    or not bool((a != 0).any()):
                raise AssertionError(f"{what}: missing, non-finite or zero")
            _bitwise(what, a, b)
        out[name] = {"inputs": len(inputs), "bitwise": True}
    log(f"  {len(cases)} cases, every gradient present, finite, non-zero "
        f"and bitwise equal to the plain version's autograd: "
        f"{', '.join(out)}")
    return out


def serve_counts_check(launches, n_layers: int, forwards: int,
                       prefills: int) -> None:
    """flash = n_layers per prefill and none per decode step; rmsnorm =
    2 n_layers + 1 per forward; every other kernel none."""
    want = {k: 0 for k in launches}
    want.update(flash_attention=n_layers * prefills,
                rmsnorm=(2 * n_layers + 1) * forwards)
    log(f"  launches {launches} (want {want})")
    assert launches == want, (launches, want)


def serve_main_path(torch, libs, profile: bool):
    """Main path 4: ``serve()`` of llama3.2-1b at full width, 8 prompts of
    1,024 tokens, 31 greedy decode steps, bf16, chunked (flash)
    attention. The counted run goes through ``serve()`` itself; then a
    second session (``build_serve_setup`` + ``generate``, the two halves
    of ``serve()``) gives the warm call, the launches of one prefill and
    of one decode step alone, the profile and the prefill logits through
    the naive attention."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_serve_setup, generate,
                                          make_prompts, serve)
    from repro_torch.models import build_model
    from repro_torch.training.step import make_decode_step, make_prefill_step

    cfg = get_config("llama3.2-1b")
    bf16, L = torch.bfloat16, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    t0 = time.perf_counter()
    first = serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                  compute_dtype=bf16, attention_impl="chunked",
                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(libs)
    serve_counts_check(launches, L, SERVE_STEPS, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = first["generated"]
    assert gen.shape == (SERVE_BATCH, SERVE_STEPS), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all(), gen

    t0 = time.perf_counter()
    model, params = build_serve_setup(cfg, compute_dtype=bf16,
                                      attention_impl="chunked",
                                      device="cuda")
    setup_s = time.perf_counter() - t0
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = generate(model, params, prompts, SERVE_STEPS)
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    same = bool((warm["generated"] == gen).all())

    # one prefill and one decode step alone, their launches counted
    tokens = {"tokens": torch.from_numpy(prompts).to("cuda")}
    cache, _ = model.cache_shape(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS,
                                 bf16)
    reset_counts(libs)
    logits, cache = make_prefill_step(model)(params, cache, tokens)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), L, 1, 1)
    assert logits.shape == (SERVE_BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    step = {"tokens": torch.argmax(logits[:, -1], -1)[:, None],
            "cache_index": SERVE_PROMPT}
    reset_counts(libs)
    dlogits, cache = make_decode_step(model)(params, cache, step)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), L, 1, 0)
    assert bool(torch.isfinite(dlogits).all()), "non-finite decode logits"

    # the same prompts and weights through the naive attention
    naive = build_model(cfg, bf16, attention_impl="naive", device="cuda")
    ncache, _ = naive.cache_shape(SERVE_BATCH, SERVE_PROMPT, bf16)
    nlogits, _ = make_prefill_step(naive)(params, ncache, tokens)
    rel = ((logits.float() - nlogits.float()).norm()
           / nlogits.float().norm()).item()
    agree = (logits.argmax(-1) == nlogits.argmax(-1)).float().mean().item()
    del ncache, nlogits

    stats = {
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
        "decode_steps": SERVE_STEPS,
        "first": {k: first[k] for k in ("prefill_s", "decode_s",
                                        "decode_tok_per_s")},
        "first_wall_s": wall,
        "warm": {k: warm[k] for k in ("prefill_s", "decode_s",
                                      "decode_tok_per_s")},
        "prefill_ms": warm["prefill_s"] * 1e3,
        "decode_ms_per_step": warm["decode_s"] / (SERVE_STEPS - 1) * 1e3,
        "decode_tok_per_s": warm["decode_tok_per_s"],
        "peak_mem_gib": warm_peak, "first_peak_mem_gib": peak,
        "setup_s": setup_s,
        "warm_tokens_equal_first": same,
        "naive_rel_norm": rel, "naive_argmax_agree": agree,
        "launches": launches}
    log(f"  first call: prefill {first['prefill_s'] * 1e3:.2f} ms, decode "
        f"{first['decode_s'] / (SERVE_STEPS - 1) * 1e3:.2f} ms/step "
        f"({first['decode_tok_per_s']:.1f} tok/s), serve() wall "
        f"{wall:.1f}s with set-up")
    log(f"  warm call: prefill {stats['prefill_ms']:.2f} ms, decode "
        f"{stats['decode_ms_per_step']:.2f} ms/step "
        f"({stats['decode_tok_per_s']:.1f} tok/s); the same tokens as the "
        f"first call: {same}; peak {warm_peak:.2f} GiB (the first call "
        f"with its set-up {peak:.2f} GiB)")
    log(f"  prefill logits, flash vs naive attention: relative norm "
        f"{rel:.3g} (bound {NAIVE_REL_TOL}), argmax agree {agree:.3f}")
    assert rel <= NAIVE_REL_TOL, rel
    if profile:
        stats["profile"] = serve_profile(torch, model, params, tokens)
    return launches, stats


def serve_profile(torch, model, params, tokens, steps: int = 4):
    """``--profile``: one prefill and ``steps`` decode steps under
    torch.profiler, each window's wall time, device busy time (the summed
    kernel time, one stream) and idle share, and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.step import make_decode_step, make_prefill_step
    prompt = tokens["tokens"].shape[1]
    cache, _ = model.cache_shape(SERVE_BATCH, prompt + steps + 1,
                                 model.compute_dtype)
    out = {}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                logits, cache = make_prefill_step(model)(params, cache,
                                                         tokens)
                n = 1
            else:
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                for i in range(steps):
                    logits, cache = make_decode_step(model)(
                        params, cache, {"tokens": tok,
                                        "cache_index": prompt + i})
                    tok = torch.argmax(logits[:, -1], -1)[:, None]
                n = steps
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        rec = {"calls": n, "wall_ms": wall / n * 1e3,
               "device_busy_ms": busy / n * 1e3,
               "device_idle_share": 1.0 - busy / wall if wall else None,
               "kernels_per_call": sum(e.count for e in kernels) / n,
               "top_kernels": [(e.key[:90], e.count // n,
                                e.self_device_time_total / n / 1e3)
                               for e in top]}
        out[phase] = rec
        log(f"  {phase} (per call, {n}): wall {rec['wall_ms']:.2f} ms, "
            f"device busy {rec['device_busy_ms']:.2f} ms (idle share "
            f"{rec['device_idle_share']:.3f}), "
            f"{rec['kernels_per_call']:.0f} kernels")
        for name, c, ms in rec["top_kernels"]:
            log(f"    device {ms:8.3f} ms x{c:4d} {name}")
    return out


def serve_reference_phase(torch):
    """Phase 9b: the reduced llama3.2-1b in f32 with the same weights on
    the card (the kernels) and on the CPU (their plain versions): prefill
    and 6 greedy decode steps, logits within rtol/atol 1e-4 (f32 sums in
    other orders) and the same tokens. TF32 is off for float32 products
    on the card (``torch.backends.cuda.matmul.allow_tf32 = False``), so
    both sides multiply in full f32."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import build_model
    from repro_torch.training.step import make_decode_step, make_prefill_step

    cfg = reduced_config(get_config("llama3.2-1b"))
    b, prompt, steps = 4, 130, 6
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sides = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, attention_impl="chunked",
                                device=dev)
            params = model.init(7)
            cache, _ = model.cache_shape(b, prompt + steps, torch.float32)
            toks = torch.from_numpy(make_prompts(cfg, b, prompt, 7)).to(dev)
            logits, cache = make_prefill_step(model)(params, cache,
                                                     {"tokens": toks})
            seq_logits, seq_tokens = [logits.cpu()], []
            for i in range(steps):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                seq_tokens.append(tok.cpu())
                logits, cache = make_decode_step(model)(
                    params, cache, {"tokens": tok, "cache_index": prompt + i})
                seq_logits.append(logits.cpu())
            sides[dev] = (seq_logits, torch.cat(seq_tokens, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card_l, card_t), (cpu_l, cpu_t) = sides["cuda"], sides["cpu"]
    err = max((a - c).abs().max().item() for a, c in zip(card_l, cpu_l))
    for i, (a, c) in enumerate(zip(card_l, cpu_l)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, i=i: f"call {i}: {m}")
    assert torch.equal(card_t, cpu_t), (card_t, cpu_t)
    log(f"  prefill + {steps} decode steps: logits within {err:.3g} "
        f"(bound rtol/atol 1e-4), greedy tokens equal "
        f"{card_t.tolist()[0]}")
    return {"max_abs_err": err, "tokens": card_t.tolist()}


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    libs = (fb, fu, bo, fi, fa, rn)

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
        f"{pair['bwd_library_ms']:.3f} ms, with threshold_backward at the "
        f"ReLU sites {pair['bwd_library_same_ms']:.3f} ms")
    log(f"  bn_stats {totals['bn_stats']['ms']:.3f} ms vs "
        f"torch.batch_norm_stats {totals['bn_stats']['batch_norm_stats_ms']:.3f}"
        f" ms; at the sites without ReLU or residual: bn_bwd_sums "
        f"{pair['plain_sites_bwd_sums_ms']:.3f} ms vs "
        f"batch_norm_backward_reduce {pair['backward_reduce_ms']:.3f} ms, "
        f"bn_bwd_dx {pair['plain_sites_bwd_dx_ms']:.3f} ms vs "
        f"batch_norm_backward_elemt {pair['backward_elemt_ms']:.3f} ms "
        f"({time.perf_counter() - t0:.1f}s)")
    division = division_check(torch)
    log(f"  ATen t / m on the card, elements whose bits differ: {division}")

    t0 = time.perf_counter()
    log("[3b] fused update, wire cast and fused input vs plain versions")
    params_cpu = model_params(cfg)
    leaves = model_leaves(params_cpu)
    wd = OptimizerConfig().weight_decay
    new = {}
    new["hybrid_update"], total = update_phase(torch, leaves, wd)
    new["hybrid_update"]["host"] = update_host_phase(torch, params_cpu)
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
    log("[3d] flash_attention and rmsnorm vs plain versions")
    lm_totals, lm_cases = lm_kernel_phase(torch)
    floor = launch_floor_phase(torch)
    rms = lm_totals["rmsnorm"]
    rms["launch_floor_ms"] = floor["decode_grid_ms"]
    log(f"  rmsnorm at a decode site {rms['decode_launch_ms'] * 1e3:.2f} "
        f"us a launch, {rms['decode_launch_ms'] / floor['decode_grid_ms']:.2f}"
        f"x the empty kernel on its grid")
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3e] gradients through the LM kernels' autograd Functions vs the "
        "plain versions' autograd")
    lm_grads = grad_phase(torch)
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

        t0 = time.perf_counter()
        log(f"[10] main path 2 with checkpoints: {CKPT_STEPS} steps, a save "
            f"every {CKPT_EVERY}, one eval batch (best checkpoint); resumed "
            f"from step {CKPT_EVERY} by a fresh Trainer, bitwise against "
            f"the unbroken run (cuDNN deterministic)")
        ckpt_stats = ckpt_phase(torch, libs, cfg)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[10b] the sentinel on main path 2: chaos {SENTINEL_CHAOS!r}, "
            f"a save every {CKPT_EVERY}, {SENTINEL_STEPS} steps")
        sentinel_stats = sentinel_phase(torch, libs, cfg)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutdown()

    t0 = time.perf_counter()
    log(f"[9] main path 4: serve() llama3.2-1b full width, batch "
        f"{SERVE_BATCH}, {SERVE_PROMPT}-token prompts, {SERVE_STEPS - 1} "
        f"greedy decode steps, bf16, chunked (flash) attention")
    launches4, stats4 = serve_main_path(torch, libs, args.profile)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[9b] reference: reduced llama3.2-1b f32, kernels on the card vs "
        "plain versions on the CPU")
    ref4 = serve_reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    by_path = {k: {"path2": launches[k], "path3": launches3[k],
                   "path4": launches4[k]} for k in launches}
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
        if k == "hybrid_update":  # the earlier design, timed in this run
            kernels[-1]["per_leaf_ms"] = t["per_leaf_ms"]
    for k, (src, replaces) in LM_KERNELS.items():
        t = lm_totals[k]
        kernels.append({
            "name": k, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches4[k],
            "launches_by_path": by_path[k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "unit": t["unit"]})
    kernels[-1]["launch_floor_ms"] = floor["decode_grid_ms"]
    assert len(kernels) == 12, len(kernels)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"),
                  "w") as f:
            json.dump({"card": card, "shapes": shape_rows, "pair": pair,
                       "kernels": kernels, "new_kernels": new,
                       "main_path": stats, "main_path_2": stats2,
                       "main_path_3": stats3, "lars_cases": lars_cases,
                       "reference": ref, "reference_2": ref2,
                       "reference_3": ref3, "turns": turns,
                       "lm_kernels": lm_totals, "lm_cases": lm_cases,
                       "lm_grads": lm_grads, "launch_floor": floor,
                       "main_path_4": stats4, "reference_4": ref4,
                       "checkpoint": ckpt_stats,
                       "sentinel": sentinel_stats,
                       "division": division}, f,
                      indent=1)
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
