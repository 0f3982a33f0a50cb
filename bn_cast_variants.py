#!/usr/bin/env python3
"""Variants of the port's ``bn_stats``, ``bn_bwd_dx`` and ``cast_copy``
kernels on one card: their launch parameters, and ``bn_stats``'s
chunking.

    python3 bn_cast_variants.py [--out DIR] [--only KERNEL ...]

Builds copies of ``src/repro_torch/kernels/csrc/fused_bn.cu`` and
``bucket_ops.cu`` that each differ from the source in its tuning
constants, into the git-ignored ``kernels/_build/variants/``, and calls
them through the same C interface:

  bn_stats   kStatsThreads (threads a block), kStatsMinBlocks (the blocks
             per SM its registers are cut for), kStatsUnroll (rows a
             thread has in flight) and kStatsMergeUnroll (partials a
             merging lane has in flight),
             each under several chunkings (the most rows of a
             single-chunk launch, the target number of blocks, the least
             rows per thread and the most chunks per merging lane of
             ``fused_bn.stats_chunks``);
             timed at every bf16 BN-site shape of ResNet-50 at batch 32
             and summed per train step (53 sites), each result held
             against the plain version as ``chip_smoke.py``'s phase 3
             holds it;
  bn_bwd_dx  kDxThreads (threads a block), kDxMinBlocks (the blocks per
             SM its registers are cut for), kDxUnroll (rows a batch; a
             thread has two batches in flight) and kDxStreaming
             (evict-first stores of dx and dres), timed at every bf16 BN-site shape of ResNet-50 at
             batch 32 and summed per train step (53 sites), each result
             bitwise against the plain version, as ``chip_smoke.py``'s
             phase 3 holds it;
  cast_copy  kCastUnroll (groups a thread has in flight) and kStreaming
             (evict-first loads and stores), timed as one pack and one
             unpack of ResNet-50's 25.56 M-element stream in bf16, each
             result bitwise against ``Tensor.to``.

Beside those, diagnostic copies of ``bn_stats`` that are not correct and
are only timed, at the source's knobs and chunking, to show where its
time goes: ``rows_only`` ends each block after its row loop (the loads
and the Welford updates), ``no_merge`` after it has written its
partials (no counter, no last-block merge), ``count_only`` after the
counter (no last-block merge), ``no_block_merge`` skips the last
block's final merge across its lanes, ``final_warp_only`` merges only
within each warp there, ``final_no_scale`` skips the scaling of M2 by
1 / rows, ``no_fence`` drops the two fences around the counter. (An
IEEE division there, ``__fdiv_rn`` per channel, took ~4 us at the
1,568-row sites; the kernel multiplies by 1 / rows from the host.)

Every time is a CUDA-graph replay (``chip_smoke.time_ms``), the variants
in turns, forward then reverse; ptxas's registers and spills are printed
beside each. ``--only`` builds and times the named kernels alone (all
three by default). Needs one CUDA card and nvcc; exits non-zero without
them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))

BN_KNOBS = ("kStatsThreads", "kStatsMinBlocks", "kStatsUnroll",
            "kStatsMergeUnroll")
CAST_KNOBS = ("kCastUnroll", "kStreaming")
# (kStatsThreads, kStatsMinBlocks, kStatsUnroll, kStatsMergeUnroll); the
# first is the source as it stands
BN_VARIANTS = [(256, 4, 4, 2), (256, 2, 8, 2), (256, 2, 8, 4),
               (512, 2, 4, 2)]
# (most rows of one chunk, target blocks, least rows per thread, most
# chunks per merging lane) of the chunking; the first is
# fused_bn.stats_chunks as it stands
CHUNK_KNOBS = ("_STATS_ONE_CHUNK_ROWS", "_STATS_TARGET_BLOCKS",
               "_STATS_MIN_THREAD_ROWS", "_STATS_LANE_CHUNKS")
CHUNKINGS = [(2048, 264, 8, 8), (0, 264, 8, 8), (8192, 264, 8, 8),
             (2048, 264, 8, 4), (2048, 264, 8, 16), (2048, 528, 8, 8)]
# diagnostic rewrites of fused_bn.cu: (anchor, replacement)
ROW_LOOP_END = ("  combine_block<V>(sh, n, m, q, ub);\n"
                "  if (chunks == 1) {")
MERGE_START = ("  // the last block of this column group to get here merges "
               "every chunk\n")
FENCES = ("    __threadfence();  // this block's partials before its count\n",
          "    __threadfence();  // every block's partials after the last "
          "count\n")
LAST_ONLY = "  if (!s_last) return;\n"
FINAL_MERGE = ("  combine_block<V>(sh, n, m, q, ub);\n"
               "  if (threadIdx.x < ub && live) {\n#pragma unroll\n"
               "    for (int j = 0; j < V; ++j) {\n      mean[c0 + j]")
FINAL_DIV = ("      var[c0 + j] = q[j] * inv_rows;  // no division on the "
             "tail\n")
DIAGNOSTICS = {
    "rows_only": [(ROW_LOOP_END, "  if (n < 0.f) pmean[0] = m[0] + q[0];  "
                   "// keeps the loop\n  return;\n" + ROW_LOOP_END)],
    "no_merge": [(MERGE_START, "  return;\n" + MERGE_START)],
    "count_only": [(LAST_ONLY, "  return;\n")],
    "no_block_merge": [(FINAL_MERGE, FINAL_MERGE.split("\n", 1)[1])],
    "final_warp_only": [(FINAL_MERGE, FINAL_MERGE.replace(
        "combine_block<V>(sh, n, m, q, ub)", "combine_warp<V>(n, m, q, ub)"))],
    "final_no_scale": [(FINAL_DIV, "      var[c0 + j] = q[j];\n")],
    "no_fence": [(f, "") for f in FENCES],
}
DX_KNOBS = ("kDxThreads", "kDxMinBlocks", "kDxUnroll", "kDxStreaming")
# (kDxThreads, kDxMinBlocks, kDxUnroll, kDxStreaming); the first is the
# source as it stands
DX_VARIANTS = [(128, 2, 4, "true"), (128, 2, 4, "false"),
               (256, 1, 4, "true"), (128, 2, 3, "true"),
               (64, 4, 4, "true"), (128, 2, 2, "true"),
               (256, 2, 2, "true"), (128, 3, 2, "true"),
               (128, 1, 8, "true")]
KERNELS = ("bn_stats", "bn_bwd_dx", "cast_copy")
# (kCastUnroll, kStreaming); the first is the source as it stands
CAST_VARIANTS = [(2, "true"), (1, "false"), (1, "true"), (2, "false"),
                 (4, "true")]


def knob_line(name: str, src: str) -> str:
    m = re.search(rf"^constexpr \w+ {name} = [^;]+;", src, re.M)
    if m is None:
        raise RuntimeError(f"{name} is no longer a constexpr line of its "
                           f"source: update bn_cast_variants.py")
    return m.group(0)


def with_knobs(src: str, values: dict) -> str:
    for name, value in values.items():
        line = knob_line(name, src)
        src = src.replace(line, re.sub(r"= [^;]+;", f"= {value};", line))
    return src


def build(build_dir: str, name: str, src: str):
    """nvcc ``src`` with the port's flags and ``-Xptxas -v``; returns the
    library and ptxas's (registers, spill bytes) by kernel."""
    from repro_torch.kernels import _build
    cu = os.path.join(build_dir, f"{name}.cu")
    so = os.path.join(build_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", so, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    info, kernel = {}, None
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(stats_kernel|dx_kernel|cast_kernel)(\w+)'",
                          line)
            kernel = m.group(1) + m.group(2)[:24] if m else None
            if kernel:
                info[kernel] = {}
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if kernel and spill:
            info[kernel]["spill_bytes"] = int(spill.group(1))
        if kernel and regs:
            info[kernel]["registers"] = int(regs.group(1))
    return ctypes.CDLL(so), info


def bind(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stats_sites(cfg):
    """((rows, C), sites) of every distinct BN-site shape."""
    from collections import Counter
    return sorted(Counter((rows, c) for _, rows, c, _, _ in cs.bn_sites(
        cfg, cs.BATCH)).items())


def chunks_for(rows: int, c: int, esize: int, threads: int, chunking):
    """``fused_bn.stats_chunks`` for another block size and chunking."""
    from repro_torch.kernels import fused_bn as fb
    names = ("_STATS_THREADS",) + CHUNK_KNOBS
    saved = [getattr(fb, k) for k in names]
    for k, v in zip(names, (threads, *chunking)):
        setattr(fb, k, v)
    try:
        return fb.stats_chunks(rows, c, esize)
    finally:
        for k, v in zip(names, saved):
            setattr(fb, k, v)


def stats_section(torch, built, cfg, record):
    """bn_stats: every variant x chunking at every site, in turns."""
    from repro_torch.kernels import fused_bn as fb
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {n: bind(lib, "bn_stats", fb._LIB.signatures["bn_stats"])
           for n, (lib, _) in built.items() if n.startswith("bn_")}
    threads = {n: int(n.split("_")[1]) for n in fns}
    threads.update({n: BN_VARIANTS[0][0] for n in built
                    if n.startswith("diag_")})
    diags = {n: bind(lib, "bn_stats", fb._LIB.signatures["bn_stats"])
             for n, (lib, _) in built.items() if n.startswith("diag_")}
    counter = torch.zeros(4096, dtype=torch.int32, device=dev)
    sites = stats_sites(cfg)
    combos = [(n, ch) for n in fns for ch in CHUNKINGS] + [
        (n, CHUNKINGS[0]) for n in diags]
    fns.update(diags)
    per_step = {f"{n} chunks{ch}": [] for n, ch in combos}
    for rows, c in [rc for rc, _ in sites]:
        count = dict(sites)[(rows, c)]
        x = (torch.randn(rows, c, generator=gen, device=dev) * 2
             + 0.5).bfloat16()
        pmean, pvar = fb.PLAIN["bn_stats"](x)
        x32 = x.float()
        mag_m = x32.abs().mean(0)
        mag_v = (x32 - pmean).square().mean(0)
        times = {}
        for turn in (combos, combos[::-1]):
            for n, ch in turn:
                rpc, chunks = chunks_for(rows, c, 2, threads[n], ch)
                scratch = torch.empty((2, chunks, c), device=dev)
                mean = torch.empty(c, device=dev)
                var = torch.empty(c, device=dev)

                def call(fn=fns[n]):
                    err = fn(x.data_ptr(), rows, c, 1, rpc,
                             scratch[0].data_ptr(), scratch[1].data_ptr(),
                             counter.data_ptr(), mean.data_ptr(),
                             var.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{n}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                if n in diags:
                    counter.zero_()  # no_merge leaves its counts behind
                    times.setdefault((n, ch), []).append(
                        cs.time_ms(torch, call))
                    counter.zero_()
                    continue
                bad = max(((mean - pmean).abs() / (mag_m + 1e-30)).max()
                          .item(), ((var - pvar).abs() / (mag_v + 1e-30))
                          .max().item())
                if not bad <= cs.SUM_TOL:
                    raise AssertionError(f"{n} chunks {ch} rows={rows} "
                                         f"C={c}: error {bad:.3g}")
                times.setdefault((n, ch), []).append(cs.time_ms(torch, call))
        for (n, ch), ts in times.items():
            key = f"{n} chunks{ch}"
            per_step[key].append({"rows": rows, "C": c, "sites": count,
                                  "ms": ts})
        lib_ms = cs.time_ms(torch, lambda: torch.var_mean(x, 0,
                                                           correction=0))
        best = min((k for k in times if k[0] not in diags),
                   key=lambda k: min(times[k]))
        print(f"  rows={rows:7d} C={c:5d} x{count:2d}: as is "
              f"{min(times[combos[0]]) * 1e3:6.2f} us, best {best} "
              f"{min(times[best]) * 1e3:6.2f} us (var_mean "
              f"{lib_ms * 1e3:6.2f}, bound "
              f"{(rows * c * 2 + 8 * c) / cs.HBM_BYTES_PER_S * 1e6:6.2f}); "
              + ", ".join(f"{n[5:]} {min(times[(n, CHUNKINGS[0])]) * 1e3:.2f}"
                          for n in diags))
        del x, x32
    totals = {k: sum(r["sites"] * min(r["ms"]) for r in v)
              for k, v in per_step.items()}
    for k, t in sorted(totals.items(), key=lambda kv: kv[1]):
        print(f"bn_stats {k}: {t:.4f} ms per step")
    record["bn_stats"] = {"per_step_ms": totals, "sites": per_step}


def cast_section(torch, built, cfg, record):
    """cast_copy: pack + unpack of the whole stream, in turns."""
    from repro_torch.kernels import bucket_ops as bo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = sum(p.numel() for p in cs.model_params(cfg).values())
    x = torch.randn(total, generator=gen, device=dev)
    w = x.bfloat16()
    cfns = {n: bind(lib, "cast_copy", bo._LIB.signatures["cast_copy"])
            for n, (lib, _) in built.items() if n.startswith("cast_")}
    outs = (torch.empty(total, dtype=torch.bfloat16, device=dev),
            torch.empty(total, device=dev))

    def caster(fn, src, dst, code_in, code_out):
        def call():
            err = fn(src.data_ptr(), code_in, dst.data_ptr(), code_out,
                     total, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cast_copy variant: CUDA error {err}")
        return call

    ctimes = {}
    for turn in (list(cfns), list(cfns)[::-1]):
        for n in turn:
            pack = caster(cfns[n], x, outs[0], 0, 1)
            unpack = caster(cfns[n], w, outs[1], 1, 0)
            pack()
            unpack()
            torch.cuda.synchronize()
            if not (torch.equal(outs[0], w) and torch.equal(outs[1],
                                                            w.float())):
                raise AssertionError(f"{n}: not bitwise equal to Tensor.to")
            ctimes.setdefault(n, []).append(
                (cs.time_ms(torch, pack), cs.time_ms(torch, unpack)))
    lib = (cs.time_ms(torch, lambda: x.to(torch.bfloat16)),
           cs.time_ms(torch, lambda: w.to(torch.float32)))
    bound_ms = 2 * 6 * total / cs.HBM_BYTES_PER_S * 1e3
    print(f"cast_copy Tensor.to: pack {lib[0]:.4f} + unpack {lib[1]:.4f} = "
          f"{sum(lib):.4f} ms (bound {bound_ms:.4f})")
    for n, ts in ctimes.items():
        print(f"cast_copy {n}: " + " / ".join(
            f"pack {p:.4f} + unpack {u:.4f} = {p + u:.4f}" for p, u in ts)
            + " ms")
    record["cast_copy"] = {"variants": ctimes, "tensor_to": lib,
                           "bound_ms": bound_ms}


def dx_section(torch, built, cfg, record):
    """bn_bwd_dx: every variant at every bf16 site shape, in turns, each
    result bitwise against the plain version."""
    from collections import Counter

    from repro_torch.kernels import fused_bn as fb
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {n: bind(lib, "bn_bwd_dx", fb._LIB.signatures["bn_bwd_dx"])
           for n, (lib, _) in built.items() if n.startswith("dx_")}
    shapes = sorted(Counter((rows, c, relu, res) for _, rows, c, relu, res
                            in cs.bn_sites(cfg, cs.BATCH)).items())
    per_step = {n: [] for n in fns}
    for (rows, c, relu, res), count in shapes:
        def rnd(*shape, dt=torch.bfloat16):
            return (torch.randn(*shape, generator=gen, device=dev) * 2
                    + 0.5).to(dt)

        x, dy = rnd(rows, c), rnd(rows, c)
        scale = 1 + 0.1 * rnd(c, dt=torch.float32)
        bias = 0.1 * rnd(c, dt=torch.float32)
        mean, var = fb.PLAIN["bn_stats"](x)
        rstd = torch.rsqrt(var + 1e-5)
        a = rstd * scale
        y = fb.PLAIN["bn_apply"](x, a, bias - mean * a, None, relu)
        s1, s2 = fb.PLAIN["bn_bwd_sums"](dy, x, y, mean, rstd, relu)
        args = (dy, x, y, mean, rstd, scale, s1, s2, None, None, 1.0 / rows,
                relu, res)
        want = fb.PLAIN["bn_bwd_dx"](*args)
        dx = torch.empty_like(x)
        dres = torch.empty_like(x) if res else None
        times = {}
        for turn in (list(fns), list(fns)[::-1]):
            for n in turn:
                def call(fn=fns[n]):
                    err = fn(dy.data_ptr(), x.data_ptr(),
                             y.data_ptr() if relu else None, mean.data_ptr(),
                             rstd.data_ptr(), scale.data_ptr(),
                             s1.data_ptr(), s2.data_ptr(), None, None,
                             1.0 / rows, float(rows), dx.data_ptr(),
                             dres.data_ptr() if res else None, rows, c, 1,
                             int(relu), torch.cuda.current_stream()
                             .cuda_stream)
                    if err:
                        raise RuntimeError(f"{n}: CUDA error {err}")

                dx.zero_()
                call()
                torch.cuda.synchronize()
                if not torch.equal(dx, want[0]) or (
                        res and not torch.equal(dres, want[1])):
                    raise AssertionError(f"{n} rows={rows} C={c}: not "
                                         f"bitwise equal to the plain version")
                times.setdefault(n, []).append(cs.time_ms(torch, call))
        for n, ts in times.items():
            per_step[n].append({"rows": rows, "C": c, "relu": relu,
                                "residual": res, "sites": count, "ms": ts})
        nbytes = cs.site_bytes(rows, c, 2, relu, res)["bn_bwd_dx"]
        first = list(fns)[0]
        best = min(times, key=lambda k: min(times[k]))
        print(f"  rows={rows:7d} C={c:5d} relu={int(relu)} res={int(res)} "
              f"x{count:2d}: as is {min(times[first]) * 1e3:6.2f} us, best "
              f"{best} {min(times[best]) * 1e3:6.2f} us (bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e6:6.2f})")
        del x, dy, y, dx, dres, want
    totals = {k: sum(r["sites"] * min(r["ms"]) for r in v)
              for k, v in per_step.items()}
    for k, t in sorted(totals.items(), key=lambda kv: kv[1]):
        print(f"bn_bwd_dx {k}: {t:.4f} ms per step")
    record["bn_bwd_dx"] = {"per_step_ms": totals, "sites": per_step}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for bn_cast_variants.json")
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels to build variants of and time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bn_cast_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_bn as fb
    cfg = get_config("resnet50")
    bn_src = (_build.CSRC / "fused_bn.cu").read_text()
    cast_src = (_build.CSRC / "bucket_ops.cu").read_text()
    as_is = tuple(int(re.search(r"= (\d+);", knob_line(k, bn_src)).group(1))
                  for k in BN_KNOBS)
    dx_as_is = tuple(re.search(r"= (\w+);", knob_line(k, bn_src)).group(1)
                     for k in DX_KNOBS)
    cast_as_is = tuple(re.search(r"= (\w+);", knob_line(k, cast_src))
                       .group(1) for k in CAST_KNOBS)
    if as_is != BN_VARIANTS[0] or (str(cast_as_is[0]), cast_as_is[1]) != \
            tuple(map(str, CAST_VARIANTS[0])) or \
            dx_as_is != tuple(map(str, DX_VARIANTS[0])):
        raise RuntimeError(f"the sources' knobs are {as_is}, {dx_as_is} and "
                           f"{cast_as_is}: update the first variants")
    if tuple(getattr(fb, k) for k in CHUNK_KNOBS) != CHUNKINGS[0] \
            or fb._STATS_THREADS != BN_VARIANTS[0][0]:
        raise RuntimeError("fused_bn.stats_chunks changed: update "
                           "CHUNKINGS[0]")
    build_dir = str(_build.BUILD_DIR / "variants")
    os.makedirs(build_dir, exist_ok=True)
    card = cs.nvidia_smi_line()
    print(f"card: {card}")

    sources = {}
    if "bn_stats" in args.only:
        for v in BN_VARIANTS:
            sources["bn_" + "_".join(map(str, v))] = with_knobs(
                bn_src, dict(zip(BN_KNOBS, v)))
        for name, edits in DIAGNOSTICS.items():
            src = bn_src
            for anchor, new in edits:
                if anchor not in src:
                    raise RuntimeError(f"fused_bn.cu no longer holds "
                                       f"{anchor!r}: update "
                                       f"bn_cast_variants.py")
                src = src.replace(anchor, new, 1)
            sources["diag_" + name] = src
    if "bn_bwd_dx" in args.only:
        for v in DX_VARIANTS:
            sources["dx_" + "_".join(map(str, v))] = with_knobs(
                bn_src, dict(zip(DX_KNOBS, v)))
    if "cast_copy" in args.only:
        for v in CAST_VARIANTS:
            sources["cast_" + "_".join(map(str, v))] = with_knobs(
                cast_src, dict(zip(CAST_KNOBS, v)))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {n: pool.submit(build, build_dir, n, s)
                   for n, s in sources.items()}
        built = {n: f.result() for n, f in futures.items()}
    record = {"card": card, "ptxas": {n: b[1] for n, b in built.items()}}
    for n, (_, info) in built.items():
        print(f"{n}: {info}")
    if "bn_stats" in args.only:
        stats_section(torch, built, cfg, record)
    if "bn_bwd_dx" in args.only:
        dx_section(torch, built, cfg, record)
    if "cast_copy" in args.only:
        cast_section(torch, built, cfg, record)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "bn_cast_variants.json"), "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
