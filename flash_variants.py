#!/usr/bin/env python3
"""Variants of the port's bf16 tensor-core flash kernel on one card: its
numerics and its register budget.

    python3 flash_variants.py [--out DIR]

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
that each differ from it in one respect, into the git-ignored
``kernels/_build/variants/``, and calls them through the same C
interface:

  numerics (an f32 output epilogue, so the error before the bf16
  rounding shows):
    three_terms          the kernel as it is: p in three bf16 terms,
                         each tile's p.v summed in a fresh accumulator
                         and added to the running one in f32
    two_terms            p in two bf16 terms, fresh accumulators
    three_terms_running  three terms summed straight into the running
                         accumulator across all tiles
    two_terms_running    two terms into the running accumulator
  register budget (the kernel's bf16 epilogue): no minimum of blocks
  per SM in the launch bounds, and a minimum of 2, 3 and 4, each with
  ptxas's registers and spills at Dh 32, 64, 96, 112 and 128.

For each numerics variant, at every case of ``chip_smoke.py``'s phase
3d in bf16: the largest |out - ref| against the plain version in f32,
that error over the row's largest |ref| in the first and the last 128
query rows, and the outputs beyond the card tests' bf16 check (one bf16
ulp beyond rtol 1e-5 / atol 1e-6) once rounded to bf16. For each
budget, the CUDA-graph times in turns at the prefill shape and at the
first Dh 128, 32, 96 and 112 cases. Needs one CUDA card and nvcc; exits
non-zero without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))

# anchors in the kernel source that the variants rewrite
EPILOGUE = "  const int r_lo = warp * 16 + g;\n"
F32_EPILOGUE = """  {
    float* of = reinterpret_cast<float*>(o) + b * os.b + h * os.h;
    for (int n = 0; n < CH; ++n)
      for (int e = 0; e < 4; ++e) {
        const int pos = q_lo + warp * 16 + g + (e >> 1) * 8;
        if (pos < sq_len)
          of[(long long)pos * os.s + n * 8 + 2 * t + (e & 1)] =
              acc[n][e] / denom[e >> 1];
      }
    return;
  }
"""
THREE_TERMS = "for (int term = 2; term >= 0; --term) {"
TILE_ACC = ("      float t0[4] = {0.f, 0.f, 0.f, 0.f}, "
            "t1[4] = {0.f, 0.f, 0.f, 0.f};\n")
RUNNING_ACC = ("      float (&t0)[4] = acc[2 * np], "
               "(&t1)[4] = acc[2 * np + 1];\n")
MERGE = """#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] = fmaf(acc[2 * np][e], corr[e >> 1], t0[e]);
        acc[2 * np + 1][e] = fmaf(acc[2 * np + 1][e], corr[e >> 1], t1[e]);
      }
"""
P_FRAGMENTS = "    // p as A fragments"
RESCALE = """    for (int n = 0; n < CH; ++n)
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
"""
BOUNDS = "__launch_bounds__(kTcThreads, tc_min_blocks<DH>())"


def numerics_variants(src: str):
    f32 = src.replace(EPILOGUE, F32_EPILOGUE + EPILOGUE)
    two = f32.replace(THREE_TERMS, THREE_TERMS.replace("= 2", "= 1"))

    def running(s):
        return (s.replace(TILE_ACC, RUNNING_ACC).replace(MERGE, "")
                .replace(P_FRAGMENTS, RESCALE + P_FRAGMENTS))

    return {"three_terms": f32, "two_terms": two,
            "three_terms_running": running(f32),
            "two_terms_running": running(two)}


def build(build_dir, name, src):
    """nvcc ``src`` with the port's flags; returns (the C entry point,
    ptxas's registers and spill bytes of flash_fwd_tc at each Dh)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    cu = os.path.join(build_dir, f"{name}.cu")
    so = os.path.join(build_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", so, cu], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    info = {}
    lines = res.stderr.splitlines()
    for i, line in enumerate(lines):
        dh = re.search(r"flash_fwd_tcILi(\d+)E", line)
        if "Compiling" in line and dh:
            rec = info.setdefault(int(dh.group(1)), {})
            for nxt in lines[i + 1:i + 5]:
                spill = re.search(r"(\d+) bytes spill stores", nxt)
                regs = re.search(r"Used (\d+) registers", nxt)
                if spill:
                    rec["spill_bytes"] = int(spill.group(1))
                if regs:
                    rec["registers"] = int(regs.group(1))
                    break
    fn = ctypes.CDLL(so).flash_attention
    fn.argtypes = fa._LIB.signatures["flash_attention"]
    fn.restype = ctypes.c_int
    return fn, info


def build_all(build_dir, sources):
    """Every variant built at once, one nvcc each: {name: (fn, info)}."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(build, build_dir, name, s)
                   for name, s in sources.items()}
        return {name: f.result() for name, f in futures.items()}


def call(torch, fn, q, k, v, causal, window, out):
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
             b, sq, sk, hq, hkv, dh, *strides, float(1.0 / math.sqrt(dh)),
             int(causal), 0 if window is None else int(window),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash variant launch failed: CUDA error {err}")
    return out


def beyond_check(torch, got, want):
    """Outputs where |got - want| > one bf16 ulp of want + 1e-6 + 1e-5
    |want| (the card tests' bf16 check)."""
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((got - want).abs() > ulp + 1e-6 + 1e-5 * want.abs()).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for flash_variants.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor in (EPILOGUE, THREE_TERMS, TILE_ACC, MERGE, P_FRAGMENTS,
                   BOUNDS):
        if anchor not in src:
            raise RuntimeError(f"flash_attention.cu no longer holds "
                               f"{anchor!r}: update flash_variants.py")
    build_dir = str(_build.BUILD_DIR / "variants")
    os.makedirs(build_dir, exist_ok=True)
    card = cs.nvidia_smi_line()
    print(f"card: {card}")
    record = {"card": card, "numerics": {}, "budget": {}}

    sources = dict(numerics_variants(src))
    budgets = {"none": "__launch_bounds__(kTcThreads)"}
    budgets.update({str(n): f"__launch_bounds__(kTcThreads, {n})"
                    for n in (2, 3, 4)})
    for key, bounds in budgets.items():
        sources[f"blocks_{key}"] = src.replace(BOUNDS, bounds)
    built = build_all(build_dir, sources)
    numerics = {name: built[name][0] for name in numerics_variants(src)}
    for case in cs.FLASH_CASES:
        b, sq, sk, hq, hkv, dh, causal, window = case
        gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
        q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                   .bfloat16() for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
        ref = fa.PLAIN["flash_attention"](q.float(), k.float(), v.float(),
                                          causal, window)
        want = ref.bfloat16().float()
        row_max = ref.abs().amax(dim=(0, 2, 3)).clamp_min(1e-30)  # per row
        for name, fn in numerics.items():
            out = call(torch, fn, q, k, v, causal, window,
                       torch.empty(q.shape, device="cuda"))
            torch.cuda.synchronize()
            err = (out - ref).abs()
            rel = err.amax(dim=(0, 2, 3)) / row_max
            rec = {"max_abs_err": err.max().item(),
                   "rel_first_128_rows": rel[:128].max().item(),
                   "rel_last_128_rows": rel[-128:].max().item(),
                   "beyond_bf16_check": beyond_check(
                       torch, out.bfloat16().float(), want),
                   "outputs": out.numel()}
            record["numerics"].setdefault(name, []).append(
                {"case": list(case), **rec})
            print(f"{name:20s} {case}: max |out - ref| "
                  f"{rec['max_abs_err']:.3g}, of the row max "
                  f"{rec['rel_first_128_rows']:.3g} (first 128 rows) / "
                  f"{rec['rel_last_128_rows']:.3g} (last 128), beyond the "
                  f"bf16 check {rec['beyond_bf16_check']} of "
                  f"{rec['outputs']}")
        del q, k, v, ref, want

    record["budget"] = {key: {"ptxas": built[f"blocks_{key}"][1], "ms": {}}
                        for key in budgets}
    cases = [cs.FLASH_CASES[0]] + [
        next(c for c in cs.FLASH_CASES if c[5] == dh)
        for dh in (128, 32, 96, 112)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in cases:
        b, sq, sk, hq, hkv, dh, causal, window = case
        q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                   .bfloat16() for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
        out = torch.empty_like(q)
        for turn in (list(budgets), list(reversed(list(budgets)))):
            for key in turn:
                fn = built[f"blocks_{key}"][0]
                record["budget"][key]["ms"].setdefault(str(case), []).append(
                    cs.time_ms(torch, lambda: call(torch, fn, q, k, v,
                                                   causal, window, out)))
        for key in budgets:
            rec = record["budget"][key]
            ptx = rec["ptxas"].get(dh, {})
            print(f"minimum blocks per SM {key:4s} at {case}: "
                  f"{ptx.get('registers')} registers, "
                  f"{ptx.get('spill_bytes')} bytes spilled, "
                  f"{' / '.join(f'{t:.4f}' for t in rec['ms'][str(case)])}"
                  f" ms")
        del q, k, v, out
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "flash_variants.json"), "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
