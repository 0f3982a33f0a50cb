#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and is right there.

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. kernels: each of the four fused-BN kernels against its plain
     PyTorch version on the card, at every BN-site shape of ResNet-50 at
     batch 32 (stem 401,408 x 64 down to stage 3 1,568 x 2,048), in bf16
     and f32, with kernel, plain and library times (CUDA events) and the
     HBM-bytes bound of each shape;
  4. main path: ``repro_torch.launch.train.build_train_setup`` for the
     full-width ResNet-50 (stages 3,4,6,3, width 64, 1000 classes, 224
     px), global batch 32, bf16, fused BN, rmsprop_warmup + slow_start,
     bf16 wire cast, driven by the ``Trainer`` for one epoch of 8
     steps and one eval batch; launch counts must be 53 per
     train step (and 53 more per eval batch for bn_apply);
  5. reference: the reduced ResNet in f32 on the card, fused kernels vs
     the unfused plain path, three steps from the same seed.
With ``--profile``, a few more main-path steps run under torch.profiler
(device busy time and idle share, top host ops and kernels).
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last the ``{"ok": true, "device": ...}`` line. ``--out DIR`` also writes
the per-shape kernel table to ``DIR/chip_smoke_kernels.json``.

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
BATCH = 32  # the paper's per-GPU minibatch (32,768 over 1,024 GPUs)
STEPS = 8  # main-path train steps: the first is set-up, 7 are timed
SOURCE = "src/repro_torch/kernels/csrc/fused_bn.cu"
REPLACES = {"bn_stats": "src/repro/kernels/fused_bn.py:54",
            "bn_apply": "src/repro/kernels/fused_bn.py:90",
            "bn_bwd_sums": "src/repro/kernels/fused_bn.py:108",
            "bn_bwd_dx": "src/repro/kernels/fused_bn.py:132"}
KERNELS = tuple(REPLACES)
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


def main_path(torch, fb, cfg, steps: int):
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
    fb.reset_launch_counts()
    result = trainer.run()
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    state = result.state

    losses = [h["loss"] for h in result.history]
    log(f"  losses {losses}")
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    tensors = list(state["params"].values())
    for tree in (state["opt"]["delta"], state["opt"]["m"]):
        tensors += list(tree.values())
    for rec in state["model_state"].values():
        tensors += list(rec.values())
    assert all(t.device.type == "cuda" for t in tensors), "tensor off card"
    assert all(bool(torch.isfinite(t).all()) for t in tensors), \
        "non-finite state"
    changed = sum(not torch.equal(p0[k], v)
                  for k, v in state["params"].items())
    assert changed == len(p0), f"only {changed}/{len(p0)} params changed"
    sites = len(state["model_state"])
    assert sites == 53, sites
    want = {"bn_stats": sites * steps, "bn_bwd_sums": sites * steps,
            "bn_bwd_dx": sites * steps,
            "bn_apply": sites * steps + sites * tcfg.val_batches}
    log(f"  launches {launches} (want {want})")
    assert launches == want, (launches, want)
    ev = result.epoch_history[-1]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["top1"] <= 1.0, ev
    step_s = [h["time"] - h["data_wait"] for h in result.history[1:]]
    med = statistics.median(step_s)
    stats = {"steps": steps, "median_step_ms": med * 1e3,
             "images_per_s": BATCH / med,
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
    num = sum(float((pf[k] - pu[k]).square().sum()) for k in pf)
    den = sum(float(pu[k].square().sum()) for k in pu)
    rel = (num / den) ** 0.5
    log(f"  fused {lf} vs unfused {lu}; param rel-norm diff {rel:.3g}")
    for a, b in zip(lf, lu):
        assert math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (lf, lu)
    assert rel < 1e-3, rel
    return {"fused_losses": lf, "unfused_losses": lu, "param_rel_norm": rel}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the per-shape kernel table")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path steps "
                         "(torch.profiler: device busy share, top ops)")
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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_bn as fb

    t_all = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build(["fused_bn"])
    log(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")

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
    log(f"[4] main path: ResNet-50 full width, batch {BATCH}, bf16, fused "
        f"BN, {STEPS} steps + 1 eval batch")
    launches, stats, live = main_path(torch, fb, cfg, STEPS)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    if args.profile:
        log("[4p] profile of the main path")
        stats["profile"] = profile_phase(torch, *live)

    t0 = time.perf_counter()
    log("[4b] reference: reduced ResNet f32, fused vs unfused on the card")
    ref = reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": totals[k]["max_abs_err"],
                "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
                "bound_ms": totals[k]["bound_ms"], "bound_by": "bytes",
                "library_ms": totals[k]["library_ms"]} for k in KERNELS]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"),
                  "w") as f:
            json.dump({"card": card, "shapes": shape_rows, "pair": pair,
                       "kernels": kernels, "main_path": stats,
                       "reference": ref}, f, indent=1)
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
