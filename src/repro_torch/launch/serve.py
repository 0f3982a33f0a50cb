"""Batched serving driver: prefill + greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --batch 4 --prompt-len 128 --decode-steps 16 \\
        --attention-impl chunked --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --batch 8 --prompt-len 1024 --decode-steps 32 --dtype bfloat16 \\
        --attention-impl chunked

The port of the JAX package's ``launch/serve.py``: the same defaults
(naive attention, float32), the same requests (``np.random.RandomState
(seed)``: the prompts, then an audio model's frames and a VLM's
patches), the same result keys, for every LM family of the registry.
The model runs on the card unless ``--device cpu`` is given; ``chunked``
attention there is the flash kernel, and every RMSNorm site the rmsnorm
kernel.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.training.step import make_decode_step, make_prefill_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_serve_setup(cfg, *, seed: int = 0, compute_dtype=torch.float32,
                      attention_impl: str = "naive",
                      device: DeviceLike = "cuda",
                      draw_device: DeviceLike = "cpu") -> Tuple:
    """(model, params) for a serving session: parameters from ``seed``
    (drawn on ``draw_device``: see ``TransformerLM.init``), cast to the
    compute dtype once, leaf by leaf as they are drawn, each f32 draw
    freed as its cast is made: the device holds the cast weights and one
    f32 leaf at most (llama4-maverick's expert leaves are 32 GB in bf16,
    one of them 21.5 GB in f32). The values are those of the JAX
    package's per-op ``astype``, and the decode loop then does not cast
    every weight again at every step (5 GB of casts a step at
    llama3.2-1b's width)."""
    model = build_model(cfg, compute_dtype=compute_dtype,
                        attention_impl=attention_impl, device=device)
    params, _ = model.init_params(seed, draw_device=draw_device,
                                  dtype=compute_dtype)
    return model, params


def build_gspmd_serve_setup(cfg, mesh_shape: Tuple[int, int], *,
                            seed: int = 0, compute_dtype=torch.float32,
                            attention_impl: str = "naive",
                            device: DeviceLike = "cuda",
                            draw_device: DeviceLike = "cpu",
                            parallel=None) -> Tuple:
    """(model, params, mesh, rules) for one worker of a GSPMD serving
    session (``make_prefill_step(model, mesh, rules)``, the cache placed
    by ``gspmd.place_cache``): the workers join (``init_workers``) and
    lay out over ("data", "model") as ``mesh_shape``, "model" the
    tensor-parallel axis (the launcher's rules: Megatron TP, MoE expert
    parallelism or TP inside the experts, the SSM families' heads), or
    by ``parallel``, a whole ``ParallelConfig`` as the JAX package's
    ``lower_cell(parallel=...)`` takes, e.g. ``cell_parallel(cfg,
    ShapeConfig("prefill", 4096, 1, "prefill"))``: sequence parallelism
    ("seq" on "model": the activations between blocks split over the
    sequence), the cache's positions on "model" ("kv_seq": ``place_cache``
    splits them, a decode step attends without gathering them), and
    FSDP's "embed" over "data" (``serve_fsdp``: each leaf gathered where
    the forward reads it). The
    weights are ``build_serve_setup``'s (drawn on ``draw_device``, each
    leaf cast as it is drawn), gathered by one worker at a time (on its
    card when the tree fits there twice over in half the free memory,
    else on the host), each worker keeping only its own slice of every
    leaf on its device: a card the workers share holds one f32 leaf of
    the draw beside the slices (llama4-maverick's one group is 35 GiB in
    bf16, one expert leaf 20 GiB in f32). On the ``meta`` device (a dry
    run, ``launch/dryrun.py``) nothing is drawn or gathered: each worker
    holds its slices' shapes."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ParallelConfig
    from repro_torch.distributed import init_workers
    from repro_torch.distributed.process_group import device_mesh
    from repro_torch.distributed.sharding import (local_slice, make_rules,
                                                  tree_shardings)
    from repro_torch.launch.train import MESH_AXES
    dev = init_workers(device)
    mesh = device_mesh(tuple(mesh_shape), MESH_AXES, device_type=dev.type)
    rules = make_rules(cfg, mesh, parallel or ParallelConfig(
        dp_axes=("data",), tp_axis="model", compression="none"))
    model = build_model(cfg, compute_dtype=compute_dtype,
                        attention_impl=attention_impl, device=dev)
    # where the whole tree waits to be sliced: the worker's card when it
    # fits there twice over (in the compute dtype and in f32, which
    # bounds the draw's f32 leaf) in half the card's free memory, else
    # the host; the same values either way
    stage = model if dev.type == "meta" else build_model(
        cfg, compute_dtype=compute_dtype, device="cpu")
    if dev.type == "cuda":
        need = cfg.param_count() * (compute_dtype.itemsize + 4)
        if need < torch.cuda.mem_get_info(dev)[0] / 2:
            stage = model
    placed = {}
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            params, axes = stage.init_params(seed, draw_device=draw_device,
                                             dtype=compute_dtype)
            shardings = tree_shardings(axes, mesh, rules)
            for k in list(params):
                v, pl = params.pop(k), tuple(shardings[k])
                placed[k] = DTensor.from_local(
                    local_slice(v, mesh, pl).to(dev, copy=True), mesh, pl,
                    shape=v.shape, stride=v.stride())
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return model, placed, mesh, rules


def make_requests(cfg, batch: int, prompt_len: int, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """The JAX package's serving inputs, bit for bit: ``tokens`` (the
    prompts), then from the same ``RandomState`` an audio model's
    ``frames`` (B, num_frames, frame_dim) and a VLM's ``patches`` (B,
    num_patches, patch_dim), float64."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size,
                                 size=(batch, prompt_len))}
    if cfg.audio is not None:
        out["frames"] = rng.randn(batch, cfg.audio.num_frames,
                                  cfg.audio.frame_dim)
    if cfg.vision is not None:
        out["patches"] = rng.randn(batch, cfg.vision.num_patches,
                                   cfg.vision.patch_dim)
    return out


def make_prompts(cfg, batch: int, prompt_len: int, seed: int = 0
                 ) -> np.ndarray:
    """The JAX package's prompts, bit for bit."""
    return make_requests(cfg, batch, prompt_len, seed)["tokens"]


def generate(model, params, prompts: np.ndarray, decode_steps: int,
             frontend: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    """Prefill ``prompts`` (with ``frontend``'s ``frames`` / ``patches``,
    cast to the compute dtype) into a fresh cache sized ``prompt_len +
    decode_steps``, as the JAX package sizes it, then ``decode_steps -
    1`` greedy decode steps. Each phase is timed between device syncs."""
    dev = model.device
    batch, prompt_len = prompts.shape
    cache, _ = model.cache_shape(batch, prompt_len + decode_steps,
                                 model.compute_dtype)
    batch_in = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    for k, v in (frontend or {}).items():
        batch_in[k] = torch.from_numpy(v).to(dev, model.compute_dtype)
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, batch_in)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tokens]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        step_batch = {"tokens": tokens, "cache_index": prompt_len + i}
        logits, cache = decode(params, cache, step_batch)
        tokens = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    generated = torch.cat(out, dim=1)
    return {
        "generated": generated.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (decode_steps - 1) / max(t_decode, 1e-9),
    }


def serve(cfg, batch: int, prompt_len: int, decode_steps: int,
          seed: int = 0, compute_dtype=torch.float32, greedy: bool = True,
          *, attention_impl: str = "naive", device: DeviceLike = "cuda",
          draw_device: DeviceLike = "cpu") -> Dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens (with an
    audio model's frames, a VLM's patches): one prefill and
    ``decode_steps - 1`` greedy decode steps. Decoding is
    greedy whatever ``greedy`` says, as in the JAX package.
    ``draw_device`` is where the random weights are drawn (the CPU:
    the same weights on every device)."""
    del greedy
    dev = resolve_device(device)
    model, params = build_serve_setup(
        cfg, seed=seed, compute_dtype=compute_dtype,
        attention_impl=attention_impl, device=dev, draw_device=draw_device)
    requests = make_requests(cfg, batch, prompt_len, seed)
    prompts = requests.pop("tokens")
    return generate(model, params, prompts, decode_steps, requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--attention-impl", default="naive",
                    choices=["naive", "chunked", "chunked_opt"])
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    res = serve(cfg, args.batch, args.prompt_len, args.decode_steps,
                compute_dtype=DTYPES[args.dtype],
                attention_impl=args.attention_impl, device=args.device)
    print(f"prefill: {res['prefill_s']*1e3:.1f} ms   "
          f"decode: {res['decode_tok_per_s']:.1f} tok/s")
    print("sample tokens:", res["generated"][0][:12])
    return res


if __name__ == "__main__":
    main()
