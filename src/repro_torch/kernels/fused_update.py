"""The fused optimizer kernels of ``csrc/fused_update.cu``, ported from
the Pallas kernels of the JAX package's ``repro/kernels/fused_update.py``:

- ``fused_hybrid_update_leaves`` (``hybrid_update``; ``_kernel``): the
  hybrid RMSprop-warm-up update (paper A.1) of every parameter leaf of a
  model in one launch, each leaf with its own scalar decay;
- ``fused_hybrid_update`` (``hybrid_update``; ``_kernel_wd``): the same
  update of one leaf or stream, with a scalar or per-element decay;
- ``fused_segment_sq_partials`` (``seg_sq_partials``;
  ``_seg_sq_kernel``) and ``fused_lars_update`` (``lars_update``;
  ``_lars_update_kernel``): the per-segment trust norms and the
  trust-scaled momentum step of LARS on the packed parameter stream.

Both update the parameter, ``delta`` and ``m`` **in place** (the Pallas
kernel writes new arrays; in place saves a second copy of the parameters
and the optimizer state) and return them. On CPU tensors they run the
plain version, ``core.optimizer.hybrid_update``, leaf by leaf; on CUDA
tensors they launch the kernel, which rounds every operation in the same
order and so is bitwise equal to it. Both entries count their launches
as ``hybrid_update``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.optimizer import HybridHyper, alpha_rmsprop, hybrid_update
from repro_torch.distributed.bucketing import segment_sq_partials
from repro_torch.kernels._launch import F32, I32, I64, P, Library, on_cpu, stream

Tensor = torch.Tensor

_LIB = Library("fused_update", {
    "hybrid_update": [P, P, P, P, P, I64, F32, F32, F32, F32, F32, F32, F32,
                      F32, P],
    "hybrid_update_leaves": [P, P, P, P, P, P, I32, F32, F32, F32, F32, F32,
                             F32, F32, P],
    "seg_sq_partials": [P, P, P, P, I64, I32, I64, P, P, P, P],
    "lars_update": [P, P, P, P, P, P, I32, I64, F32, F32, P],
}, counts_as={"hybrid_update_leaves": "hybrid_update"})
# the leaves one launch of hybrid_update_leaves takes (kMaxLeaves)
MAX_LEAVES = 256
# elements per block of seg_sq_partials' first pass (kChunk in the source)
SEG_CHUNK = 4096
# the largest trust vector lars_update stages in shared memory (48 KB)
MAX_SEGMENTS = 12288
LAUNCHES: Dict[str, int] = _LIB.launches
# per C entry: "hybrid_update" (one leaf or stream, the decay-stream entry
# ZeRO runs) apart from "hybrid_update_leaves" (the per-leaf optimizer's)
ENTRY_LAUNCHES: Dict[str, int] = _LIB.entry_launches
reset_launch_counts = _LIB.reset


def _hybrid_update_plain(g, p, d, m, h: HybridHyper,
                         weight_decay: Union[float, Tensor] = 0.0):
    p2, d2, m2 = hybrid_update(g, p, d, m, h, weight_decay)
    p.copy_(p2)
    d.copy_(d2)
    m.copy_(m2)
    return p, d, m


def _seg_sq_partials_plain(p, g, wd, seg, num_segments: int) -> Tensor:
    p32 = p.float()
    g_eff = g.float() + wd * p32
    return torch.stack([segment_sq_partials(p32, seg, num_segments),
                        segment_sq_partials(g_eff, seg, num_segments)])


def _lars_update_plain(g, p, d, wd, seg, trust, eta: float, mu1: float):
    g_eff = g + wd * p
    d_new = mu1 * d - torch.index_select(trust, 0, seg) * g_eff
    p_new = p + eta * d_new
    p.copy_(p_new)
    d.copy_(d_new)
    return p, d


PLAIN = {"hybrid_update": _hybrid_update_plain,
         "seg_sq_partials": _seg_sq_partials_plain,
         "lars_update": _lars_update_plain}


def _f32(v) -> float:
    return float(np.float32(v))


def fused_hybrid_update(g: Tensor, p: Tensor, d: Tensor, m: Tensor,
                        h: HybridHyper,
                        weight_decay: Union[float, Tensor] = 0.0
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """One leaf of the hybrid update, **in place** over ``p``, ``d`` and
    ``m`` (all float32, contiguous, the same shape as ``g``); returns
    ``(p, d, m)``."""
    wd_t = weight_decay if torch.is_tensor(weight_decay) else None
    with torch.no_grad():
        if on_cpu("fused update", g, p, d, m, wd_t):
            return _hybrid_update_plain(g, p, d, m, h, weight_decay)
        for name, t in (("g", g), ("p", p), ("delta", d), ("m", m),
                        ("weight_decay", wd_t)):
            if t is None:
                continue
            if t.dtype != torch.float32 or t.shape != p.shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"fused update: {name} must be contiguous float32 of "
                    f"shape {tuple(p.shape)}, got {t.dtype} "
                    f"{tuple(t.shape)}")
        _LIB.launch(
            "hybrid_update", g.data_ptr(), p.data_ptr(), d.data_ptr(),
            m.data_ptr(), None if wd_t is None else wd_t.data_ptr(),
            p.numel(), *_hyper_args(h),
            0.0 if wd_t is not None else _f32(weight_decay), stream())
    return p, d, m


def _hyper_args(h: HybridHyper):
    """The kernel's f32 scalars, rounded from the plain version's
    doubles: eta, a_sgd, a_rms, mu1, mu2, 1 - mu2, eps."""
    return (_f32(h.eta), _f32(h.alpha_sgd), alpha_rmsprop(h), _f32(h.mu1),
            _f32(h.mu2), _f32(1.0 - h.mu2), _f32(h.eps))


def fused_hybrid_update_leaves(gs: Sequence[Tensor], ps: Sequence[Tensor],
                               ds: Sequence[Tensor], ms: Sequence[Tensor],
                               h: HybridHyper, wds: Sequence[float]
                               ) -> Tuple[Sequence[Tensor], Sequence[Tensor],
                                          Sequence[Tensor]]:
    """Every leaf of the hybrid update, **in place** over each ``ps[i]``,
    ``ds[i]`` and ``ms[i]`` (float32, contiguous, the shape of ``gs[i]``,
    which may be a view into a larger buffer), leaf ``i`` with the scalar
    decay ``wds[i]``; returns ``(ps, ds, ms)``.

    On the card: one launch for up to ``MAX_LEAVES`` leaves (ResNet-50's
    161 take one), bitwise equal to ``fused_hybrid_update`` per leaf."""
    with torch.no_grad():
        if not len(gs) == len(ps) == len(ds) == len(ms) == len(wds):
            raise ValueError(
                f"fused update: {len(gs)} g, {len(ps)} p, {len(ds)} delta, "
                f"{len(ms)} m and {len(wds)} decays")
        if on_cpu("fused update", *gs, *ps, *ds, *ms):
            for g, p, d, m, wd in zip(gs, ps, ds, ms, wds):
                _hybrid_update_plain(g, p, d, m, h, wd)
            return ps, ds, ms
        live = []
        for i, leaf in enumerate(zip(gs, ps, ds, ms)):
            shape = leaf[1].shape
            for name, t in zip(("g", "p", "delta", "m"), leaf):
                if t.dtype != torch.float32 or t.shape != shape \
                        or not t.is_contiguous():
                    raise ValueError(
                        f"fused update: leaf {i}'s {name} must be contiguous "
                        f"float32 of shape {tuple(shape)}, got {t.dtype} "
                        f"{tuple(t.shape)}")
            if leaf[1].numel():
                live.append(i)
        hyper, st = _hyper_args(h), stream()
        for lo in range(0, len(live), MAX_LEAVES):
            part = live[lo:lo + MAX_LEAVES]
            ptrs = [np.fromiter((ts[i].data_ptr() for i in part), np.uint64,
                                len(part)) for ts in (gs, ps, ds, ms)]
            n = np.fromiter((ps[i].numel() for i in part), np.int64,
                            len(part))
            wd = np.fromiter((wds[i] for i in part), np.float32, len(part))
            _LIB.launch("hybrid_update_leaves",
                        *(a.ctypes.data for a in (*ptrs, n, wd)), len(part),
                        *hyper, st)
    return ps, ds, ms


def _check_stream(what: str, n: int, **ts: Tensor) -> None:
    if n == 0:
        raise ValueError(f"{what}: empty stream")
    for name, t in ts.items():
        want = torch.int32 if name == "seg" else torch.float32
        if t.dtype != want or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous 1-D {want} tensor of "
                f"{n} elements, got {t.dtype} {tuple(t.shape)}")


def fused_segment_sq_partials(p: Tensor, g: Tensor, wd: Tensor, seg: Tensor,
                              num_segments: int) -> Tensor:
    """(2, num_segments) f32 per-segment sums of ``[p^2, (g + wd*p)^2]``
    over a flat stream (f32 ``p``, ``g``, ``wd``; int32 ``seg``). Ids
    outside ``[0, num_segments)`` are dropped.

    The kernel is fastest when the ids are non-decreasing, as they are
    along the packed stream and every ``local_shard`` of it
    (``segment_ids_stream`` asserts it); any order gives the same sums.
    It agrees with the plain version to rounding (another fold order)
    and gives the same bits on every run."""
    with torch.no_grad():
        if on_cpu("segment norms", p, g, wd, seg):
            return _seg_sq_partials_plain(p, g, wd, seg, num_segments)
        n = p.numel()
        _check_stream("segment norms", n, p=p, g=g, wd=wd, seg=seg)
        if num_segments < 1:
            raise ValueError(f"num_segments must be >= 1, got "
                             f"{num_segments}")
        n_chunks = -(-n // SEG_CHUNK)
        out = torch.empty(2, num_segments, dtype=torch.float32,
                          device=p.device)
        part = torch.empty(num_segments * n_chunks * 2, dtype=torch.float32,
                           device=p.device)
        rng = torch.empty(n_chunks * 2, dtype=torch.int32, device=p.device)
        _LIB.launch("seg_sq_partials", g.data_ptr(), p.data_ptr(),
                    wd.data_ptr(), seg.data_ptr(), n, num_segments, n_chunks,
                    part.data_ptr(), rng.data_ptr(), out.data_ptr(), stream())
    return out


def fused_lars_update(g: Tensor, p: Tensor, d: Tensor, wd: Tensor,
                      seg: Tensor, trust: Tensor, eta: float, mu1: float
                      ) -> Tuple[Tensor, Tensor]:
    """The trust-scaled momentum step of LARS on a flat stream, **in
    place** over ``p`` and ``d``; returns ``(p, d)``::

        d' = mu1 * d - trust[seg] * (g + wd * p);   p' = p + eta * d'

    ``g``, ``p``, ``d``, ``wd`` f32, ``seg`` int32 ids into ``trust``
    (f32, one value per segment). ``eta`` and ``mu1`` are rounded to f32
    from the same doubles the plain version rounds, so the kernel is
    bitwise equal to it."""
    with torch.no_grad():
        if on_cpu("LARS update", g, p, d, wd, seg, trust):
            return _lars_update_plain(g, p, d, wd, seg, trust, eta, mu1)
        n = p.numel()
        _check_stream("LARS update", n, g=g, p=p, d=d, wd=wd, seg=seg)
        n_seg = trust.numel()
        if trust.dtype != torch.float32 or trust.dim() != 1 \
                or not trust.is_contiguous() or not 1 <= n_seg <= MAX_SEGMENTS:
            raise ValueError(
                f"LARS update: trust must be a contiguous 1-D float32 tensor "
                f"of 1 to {MAX_SEGMENTS} segments, got {trust.dtype} "
                f"{tuple(trust.shape)}")
        _LIB.launch("lars_update", g.data_ptr(), p.data_ptr(), d.data_ptr(),
                    wd.data_ptr(), seg.data_ptr(), trust.data_ptr(), n_seg, n,
                    _f32(eta), _f32(mu1), stream())
    return p, d
