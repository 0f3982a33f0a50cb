"""ResNet-50 in PyTorch, the paper's own benchmark architecture.

Activations are NHWC tensors, contiguous: the ``(rows, C)`` view every BN
site works on costs nothing. A convolution runs on the NCHW view of the
same memory, which is ``torch.channels_last``, and hands its output back
as NHWC. Padding follows the JAX package's ``SAME`` rule, which is
asymmetric for stride 2 (the 7x7/s2 stem pads (2, 3), the 3x3/s2 convs
and max-pool pad (0, 1)), so it is applied with ``F.pad`` where torch's
symmetric ``padding=`` would differ.

BatchNorm follows the paper's §2 variant: no moving averages. The last
minibatch's statistics are the model state, and eval normalizes with
them. Each BN site carries its epilogue (ReLU, residual add) so the
fused kernels (``kernels/fused_bn.py``) can fold it in. ``bn_group`` (a
process group) makes every train-mode site cross-replica BN (sync-BN)
over its workers; given-statistics (eval) sites are unchanged.

``apply`` composes three per-segment forwards (stem, each stage, the
head); ``loss_segments`` hands the same forwards to the overlapped
data-parallel step as a chain of K = 2 + stages segments, so both
paths run the same ops.

Parameters are named after the JAX package's paths
(``stage1/block0/proj_bn/scale``); conv weights are OIHW and the fc
weight keeps the ``(C_in, classes)`` layout. ``apply`` is functional in
the parameters, like the JAX model, so the train step can cast them to
the compute dtype first; ``forward`` uses the module's own parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.batchnorm import bn_apply_stats, bn_batch_stats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import common
from repro_torch.models.common import StagedLoss

Tensor = torch.Tensor
Params = Dict[str, Tensor]
State = Dict[str, Dict[str, Tensor]]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's ``SAME`` rule along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _pad_nchw(x: Tensor, k: int, stride: int, value: float = 0.0):
    """SAME-pad an NCHW view; returns (x, symmetric padding to hand to the
    op, or 0 when the pad was applied here)."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """NHWC x (*) OIHW w with SAME padding; w is cast to x's dtype."""
    xn, pad = _pad_nchw(_nchw(x), w.shape[2], stride)
    return _nhwc(F.conv2d(xn, w.to(x.dtype), stride=stride, padding=pad))


def max_pool_3x3_s2(x: Tensor) -> Tensor:
    xn, _ = _pad_nchw(_nchw(x), 3, 2, value=float("-inf"))
    return _nhwc(F.max_pool2d(xn, 3, 2))


class ResNet50(nn.Module):
    """Bottleneck ResNet. ``model_state`` carries last-minibatch BN stats
    as ``{site: {"mean", "var", "count"}}``."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 fused_bn: Optional[bool] = None, *, seed: int = 0,
                 device: DeviceLike = "cuda", bn_group=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.fused_bn = (bool(cfg.fused_bn) if fused_bn is None
                         else bool(fused_bn))
        self.bn_group = bn_group
        self.device = resolve_device(device)
        # a model on the meta device draws nothing (training/specs.py)
        gen = common.LeafDraw(None if self.device.type == "meta" else
                              torch.Generator().manual_seed(seed))
        for name, value in self._init_values(gen).items():
            self.register_parameter(name, nn.Parameter(value.to(self.device)))

    # ------------------------------------------------------------- init
    def _blocks(self, stage: Optional[int] = None):
        """(stage, block, c_in, mid, c_out, stride) for every block (of
        ``stage`` alone, if given)."""
        w = self.cfg.conv_width
        c_in = w
        for si, blocks in enumerate(self.cfg.conv_stages):
            mid = w * (2 ** si)
            c_out = mid * 4
            for bi in range(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                if stage is None or stage == si:
                    yield si, bi, c_in, mid, c_out, stride
                c_in = c_out

    def _init_values(self, gen: common.LeafDraw) -> Params:
        cfg = self.cfg
        w = cfg.conv_width

        def conv_w(k, c_in, c_out):
            return common.he_init(gen, (c_out, c_in, k, k), k * k * c_in)

        p: Params = {"stem/conv": conv_w(7, 3, w)}
        p.update(_bn_values("stem/bn", w))
        c_last = w
        for si, bi, c_in, mid, c_out, _ in self._blocks():
            pre = f"stage{si}/block{bi}"
            p[f"{pre}/conv1"] = conv_w(1, c_in, mid)
            p[f"{pre}/conv2"] = conv_w(3, mid, mid)
            p[f"{pre}/conv3"] = conv_w(1, mid, c_out)
            if bi == 0:
                p[f"{pre}/proj"] = conv_w(1, c_in, c_out)
            for bn, c in (("bn1", mid), ("bn2", mid), ("bn3", c_out)):
                p.update(_bn_values(f"{pre}/{bn}", c))
            if bi == 0:
                p.update(_bn_values(f"{pre}/proj_bn", c_out))
            c_last = c_out
        p["fc/w"] = common.fan_in_init(gen, (c_last, cfg.num_classes))
        p["fc/b"] = torch.zeros(cfg.num_classes)
        return p

    def params(self) -> Params:
        """The module's parameters by their JAX-path names."""
        return dict(self.named_parameters())

    def init_params(self, seed: Optional[int] = None):
        """``(params, logical axes)`` as the JAX package's; the
        parameters were drawn when the module was built (``seed`` is
        that one's)."""
        del seed
        return {k: p.detach() for k, p in self.named_parameters()}, \
            self.axes()

    def axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes: a conv weight's are the JAX
        package's HWIO ``(None, None, "conv_in", "conv_out")`` in the
        port's OIHW order."""
        conv = ("conv_out", "conv_in", None, None)
        bn = {"scale": ("conv_out",), "bias": ("conv_out",)}
        a = {"stem/conv": conv}
        a.update(common.prefixed("stem/bn", bn))
        for si, bi, *_ in self._blocks():
            pre = f"stage{si}/block{bi}"
            names = ("conv1", "conv2", "conv3") + (("proj",) if bi == 0
                                                  else ())
            a.update({f"{pre}/{n}": conv for n in names})
            for n in ("bn1", "bn2", "bn3") + (("proj_bn",) if bi == 0
                                              else ()):
                a.update(common.prefixed(f"{pre}/{n}", bn))
        a.update({"fc/w": ("conv_in", None), "fc/b": (None,)})
        return a

    def init_state(self) -> State:
        """BN last-minibatch stats, zero-initialized (mean 0 / var 1)."""
        w = self.cfg.conv_width
        state: State = {"stem/bn": self._stat(w)}
        for si, bi, _, mid, c_out, _ in self._blocks():
            pre = f"stage{si}/block{bi}"
            state[f"{pre}/bn1"] = self._stat(mid)
            state[f"{pre}/bn2"] = self._stat(mid)
            state[f"{pre}/bn3"] = self._stat(c_out)
            if bi == 0:
                state[f"{pre}/proj_bn"] = self._stat(c_out)
        return state

    def _stat(self, c: int) -> Dict[str, Tensor]:
        dev = self.device
        return {"mean": torch.zeros(c, device=dev),
                "var": torch.ones(c, device=dev),
                "count": torch.zeros((), device=dev)}

    # -------------------------------------------------------------- fwd
    def _bn(self, p: Params, x: Tensor, name: str, state: State,
            new_state: Optional[State], relu: bool = False,
            residual: Optional[Tensor] = None) -> Tensor:
        """One BN site with its epilogue (optional ReLU / residual add).
        ``new_state`` is None in eval, which normalizes with ``state``."""
        scale, bias = p[f"{name}/scale"], p[f"{name}/bias"]
        if new_state is not None:
            if self.fused_bn:
                from repro_torch.kernels.ops import fused_bn_train
                y, mean, var = fused_bn_train(x, scale, bias,
                                              residual=residual, relu=relu,
                                              group=self.bn_group)
                new_state[name] = _stat_record(mean, var)
                return y
            mean, var = bn_batch_stats(x, group=self.bn_group)
            new_state[name] = _stat_record(mean, var)
        else:
            mean, var = state[name]["mean"], state[name]["var"]
            if self.fused_bn:
                from repro_torch.kernels.ops import fused_bn_apply
                return fused_bn_apply(x, mean, var, scale, bias,
                                      residual=residual, relu=relu)
        y = bn_apply_stats(x, mean, var, scale, bias)
        if residual is not None:
            y = y + residual
        if relu:
            y = F.relu(y)
        return y

    # per-segment forwards: ``apply`` composes them, ``loss_segments``
    # chains them for the overlapped step
    def _stem_fwd(self, p: Params, images: Tensor, state: State,
                  new_state: Optional[State]) -> Tensor:
        x = constrain(images.to(self.compute_dtype),
                      ("batch", None, None, None))
        x = conv(x, p["stem/conv"], stride=2)
        x = self._bn(p, x, "stem/bn", state, new_state, relu=True)
        return max_pool_3x3_s2(x)

    def _stage_fwd(self, si: int, p: Params, x: Tensor, state: State,
                   new_state: Optional[State]) -> Tensor:
        for _, bi, _, _, _, stride in self._blocks(si):
            pre = f"stage{si}/block{bi}"
            if bi == 0:
                sc = conv(x, p[f"{pre}/proj"], stride=stride)
                sc = self._bn(p, sc, f"{pre}/proj_bn", state, new_state)
            else:
                sc = x
            out = conv(x, p[f"{pre}/conv1"])
            out = self._bn(p, out, f"{pre}/bn1", state, new_state, relu=True)
            out = conv(out, p[f"{pre}/conv2"], stride=stride)
            out = self._bn(p, out, f"{pre}/bn2", state, new_state, relu=True)
            out = conv(out, p[f"{pre}/conv3"])
            # block output: BN + residual add + ReLU, one fused site
            x = self._bn(p, out, f"{pre}/bn3", state, new_state, relu=True,
                         residual=sc)
        return x

    @staticmethod
    def _head_logits(p: Params, x: Tensor) -> Tensor:
        x = x.mean(dim=(1, 2))
        logits = x @ p["fc/w"].to(x.dtype) + p["fc/b"].to(x.dtype)
        return logits.float()

    def apply(self, p: Params, state: State, images: Tensor,
              train: bool = True) -> Tuple[Tensor, State]:
        """Logits (f32) and the new BN state (``state`` itself in eval).
        ``images`` are NHWC."""
        new_state: Optional[State] = {} if train else None
        x = self._stem_fwd(p, images, state, new_state)
        for si in range(len(self.cfg.conv_stages)):
            x = self._stage_fwd(si, p, x, state, new_state)
        return self._head_logits(p, x), (new_state if train else state)

    def forward(self, images: Tensor, state: State,
                train: bool = False) -> Tuple[Tensor, State]:
        return self.apply(self.params(), state, images, train)

    # ------------------------------------------------------------ losses
    @staticmethod
    def _softmax_xent(logits: Tensor, labels: Tensor,
                      label_smoothing: float):
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels[:, None])[:, 0]
        if label_smoothing:
            nll = (1 - label_smoothing) * nll - label_smoothing * logp.mean(
                dim=-1)
        loss = nll.mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    def loss_fn(self, p: Params, model_state: State, batch,
                label_smoothing: float = 0.0):
        """(loss, (new_state, {"loss", "accuracy"})) for a train batch of
        tensors ``{"images": NHWC, "labels": int64}``."""
        logits, new_state = self.apply(p, model_state, batch["images"],
                                       train=True)
        loss, acc = self._softmax_xent(logits, batch["labels"],
                                       label_smoothing)
        return loss, (new_state, {"loss": loss.detach(),
                                  "accuracy": acc})

    def segment_names(self) -> Tuple[str, ...]:
        """The staged loss's segments, forward order: stem /
        stage0..stageN / fc."""
        return (("stem",) + tuple(f"stage{si}" for si in
                                  range(len(self.cfg.conv_stages)))
                + ("fc",))

    def segment_trees(self, tree: Dict) -> List[Dict]:
        """A parameter-shaped dict cut into the staged loss's segments
        (forward order): a segment holds the names whose first component
        is its own."""
        return [{k: v for k, v in tree.items()
                 if k.split("/", 1)[0] == name}
                for name in self.segment_names()]

    def loss_segments(self, p: Params, model_state: State, batch,
                      label_smoothing: float = 0.0) -> StagedLoss:
        """The loss as K = 2 + stages chained segments
        (``segment_names``), each over its ``segment_trees`` share of the
        parameters; each segment's aux is its BN state fragment (the
        head's: ``({}, metrics)``)."""
        n_stages = len(self.cfg.conv_stages)

        def stem_fn(sp, images):
            frag: State = {}
            return self._stem_fwd(sp, images, model_state, frag), frag

        def make_stage_fn(si):
            def stage_fn(sp, x):
                frag: State = {}
                return self._stage_fwd(si, sp, x, model_state, frag), frag
            return stage_fn

        def head_fn(sp, x):
            loss, acc = self._softmax_xent(self._head_logits(sp, x),
                                           batch["labels"], label_smoothing)
            return loss, ({}, {"loss": loss.detach(), "accuracy": acc})

        seg_fns = (stem_fn,) + tuple(make_stage_fn(si)
                                     for si in range(n_stages)) + (head_fn,)

        def finalize_aux(auxes):
            new_state: State = {}
            for frag in auxes[:-1]:
                new_state.update(frag)
            frag, metrics = auxes[-1]
            new_state.update(frag)
            return new_state, metrics

        return StagedLoss(names=self.segment_names(),
                          seg_params=tuple(self.segment_trees(p)),
                          seg_fns=seg_fns, x0=batch["images"],
                          finalize_aux=finalize_aux)

    def eval_fn(self, p: Params, model_state: State, batch):
        """Validation metrics with frozen (last-minibatch) BN stats."""
        logits, _ = self.apply(p, model_state, batch["images"], train=False)
        loss, top1 = self._softmax_xent(logits, batch["labels"], 0.0)
        return {"top1": top1, "loss": loss}


def _bn_values(name: str, c: int) -> Params:
    return {f"{name}/scale": torch.ones(c), f"{name}/bias": torch.zeros(c)}


def _stat_record(mean: Tensor, var: Tensor) -> Dict[str, Tensor]:
    return {"mean": mean.detach(), "var": var.detach(),
            "count": torch.ones((), device=mean.device)}
