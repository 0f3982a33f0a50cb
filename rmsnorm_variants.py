#!/usr/bin/env python3
"""Variants of the port's ``rmsnorm`` launch on one card, beside its
yardsticks, at the main paths' prefill and training rows.

    python3 rmsnorm_variants.py [--out DIR]

Builds ``src/repro_torch/kernels/csrc/rmsnorm.cu`` once more with
``-Xptxas -v`` (into the git-ignored ``kernels/_build/variants/``) and
prints each instance's registers and spills. Then, at each shape, times
through the library's own C entry:

  plan     the launch ``kernels/rmsnorm.py`` plans (``plan_for``);
  flipped  the same held instance with the evict-first hint flipped (on
           where x fits L2, off where it does not);
  generic  the generic instance ``rmsnorm_any`` in the same layout (the
           row read twice, element by element);
  copy_    ``Tensor.copy_`` of x: the same bytes read and written by a
           copy, what the memory system gives a kernel of no arithmetic;
  F.rms_norm  PyTorch's own call, with the same bf16 scale.

Each variant's output is held bitwise against the plan's (the hint and
the generic instance keep the sum order). Every time is a CUDA-graph
replay (``chip_smoke.time_ms``), the variants in turns, forward then
reverse, the median of the two; the bound is x and y moved once at 3.35
TB/s. Needs one CUDA card and nvcc; exits non-zero without them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
# (rows, d, dtype): prefill rows at every RMSNorm width of the registry
# (phi-3-vision's 12,800 with its patches, mixtral's 4,064-token prompts
# at 32,512), the training rows, and one f32 prefill
SHAPES = [(8192, 2048, "bf16"), (12800, 3072, "bf16"),
          (8192, 3584, "bf16"), (8192, 4096, "bf16"), (8192, 5120, "bf16"),
          (8192, 7168, "bf16"), (8192, 8192, "bf16"),
          (32512, 4096, "bf16"), (4096, 2048, "bf16"),
          (4096, 4096, "bf16"), (8192, 2048, "f32")]


def ptxas_lines(_build) -> list:
    """'instance: N registers, S bytes spill stores' for each kernel."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / "librmsnorm-ptxas.so"),
         str(_build.CSRC / "rmsnorm.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    lines, name, spill = [], None, "?"
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            inst = re.search(r"rmsnorm_(held|any)I\w+?EEv", name)
            lines.append(f"{inst.group(0) if inst else name}: "
                         f"{m.group(1)} registers, {spill} bytes spill "
                         f"stores")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels._launch import stream

    card = cs.nvidia_smi_line()
    print(card)
    regs = ptxas_lines(_build)
    print("\n".join(regs))
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(26)
    records = []
    for rows, d, dname in SHAPES:
        dt = dtypes[dname]
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 2
             + 0.3).to(dt)
        st = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
        y = torch.empty_like(x)
        plan = rn.plan_for(x, st, y)
        code = rn._CODE[dt]

        # what a misaligned x of this shape gets: the generic instance
        # on its own grid
        generic = rn._device_plan(torch.cuda.current_device(), rows, d, dt,
                                  False)

        def launch(p, out):
            rn._LIB.launch("rmsnorm", x.data_ptr(), st.data_ptr(),
                           out.data_ptr(), code, rows, d, 1e-5, 1, *p,
                           stream())

        outs = {k: torch.empty_like(x) for k in ("flipped", "generic")}
        variants = {
            "plan": lambda: launch(plan, y),
            "flipped": lambda: launch(plan._replace(evict=not plan.evict),
                                      outs["flipped"]),
            "generic": lambda: launch(generic, outs["generic"]),
            "copy_": lambda: y.copy_(x),
            "F.rms_norm": lambda: F.rms_norm(x, (d,), st, 1e-5),
        }
        launch(plan, y)
        for k in outs:
            variants[k]()
        torch.cuda.synchronize()
        for k, o in outs.items():
            cs._bitwise(f"rmsnorm {k} {rows} x {d} {dname}", o, y)
        runs = {k: [] for k in variants}
        for order in (list(variants), list(reversed(variants))):
            for k in order:
                runs[k].append(cs.time_ms(torch, variants[k]))
        ms = {k: statistics.median(v) for k, v in runs.items()}
        bound_ms, _ = cs.bound(x.element_size() * (2 * rows * d + d),
                               4 * rows * d)
        rec = {"rows": rows, "d": d, "dtype": dname, "plan": list(plan),
               "generic_plan": list(generic),
               "bound_ms": bound_ms, "ms": ms,
               "share_of_bound": {k: bound_ms / v for k, v in ms.items()}}
        records.append(rec)
        times = ", ".join(f"{k} {v:.4f} ({bound_ms / v:.0%})"
                          for k, v in ms.items())
        print(f"{dname} {rows:6d} x {d:5d} plan {tuple(plan)}: bound "
              f"{bound_ms:.4f} ms; {times}", flush=True)
        del x, y, outs
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "rmsnorm_variants.json")
        with open(path, "w") as f:
            json.dump({"card": card, "ptxas": regs, "shapes": records}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
