"""Plain ResNet-50 (He et al. 2016, arXiv:1512.03385), trained as the
paper trains it (arXiv:1711.04325 §2): BatchNorm with the minibatch's
own statistics and no moving averages, softmax cross entropy.

Written fresh in plain PyTorch and frozen against the port's
``models/resnet.py``, ``core/batchnorm.py`` and
``kernels/fused_input.py``. What it shares with the port by design: the
parameter names (``stage1/block0/conv2``, ``.../bn1/scale``, ``fc/w``),
OIHW conv weights and the ``(C_in, classes)`` fc weight, the stride on
the 3x3 conv of a bottleneck (v1.5), XLA's asymmetric ``SAME`` padding,
NHWC images in and bf16 activations with f32 BN statistics (centered
variance, eps 1e-5). Departures: NCHW inside; each BN site normalizes in
float32 and rounds once (the port's fused kernel); the input's flip and
cyclic shift are gathers (``augment``), with the parameters drawn by a
frozen copy of the port's ``input_augment_params`` (its numpy Philox
stream keyed by ``(seed, step)``). Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Leaf, Precision, fan_in_leaf

BF16 = torch.bfloat16
BN_EPS = 1e-5
_AUGMENT_DOMAIN = 0x1A6_3E17


def blocks(model: Dict):
    """(stage, block, c_in, mid, c_out, stride) of every bottleneck."""
    w = model["conv_width"]
    c_in = w
    for si, n in enumerate(model["conv_stages"]):
        mid = w * 2 ** si
        for bi in range(n):
            yield si, bi, c_in, mid, mid * 4, 2 if bi == 0 and si > 0 else 1
            c_in = mid * 4


def leaf_specs(model: Dict) -> List[Leaf]:
    """Every parameter with its He (convs) or fan-in (fc) initializer."""
    w = model["conv_width"]

    def conv(name, k, c_in, c_out):
        return fan_in_leaf(name, (c_out, c_in, k, k), k * k * c_in, 2.0)

    def bn(name, c):
        return [Leaf(f"{name}/scale", (c,), "ones"),
                Leaf(f"{name}/bias", (c,), "zeros")]

    out = [conv("stem/conv", 7, 3, w)] + bn("stem/bn", w)
    c_last = w
    for si, bi, c_in, mid, c_out, _ in blocks(model):
        pre = f"stage{si}/block{bi}"
        out += [conv(f"{pre}/conv1", 1, c_in, mid),
                conv(f"{pre}/conv2", 3, mid, mid),
                conv(f"{pre}/conv3", 1, mid, c_out)]
        if bi == 0:
            out.append(conv(f"{pre}/proj", 1, c_in, c_out))
        out += bn(f"{pre}/bn1", mid) + bn(f"{pre}/bn2", mid) + \
            bn(f"{pre}/bn3", c_out)
        if bi == 0:
            out += bn(f"{pre}/proj_bn", c_out)
        c_last = c_out
    out += [fan_in_leaf("fc/w", (c_last, model["num_classes"]), c_last),
            Leaf("fc/b", (model["num_classes"],), "zeros")]
    return out


def augment_params(seed: int, step: int, total: int, max_shift: int
                   ) -> np.ndarray:
    """(total, 4) int32 ``[flip, dy, dx, 0]`` of ``step`` (frozen copy of
    the port's ``input_augment_params``)."""
    rng = np.random.Generator(np.random.Philox(
        key=np.array([(seed << 32) ^ _AUGMENT_DOMAIN, step],
                     dtype=np.uint64)))
    out = np.zeros((total, 4), np.int32)
    out[:, 0] = rng.integers(0, 2, total)
    out[:, 1:3] = rng.integers(-max_shift, max_shift + 1, (total, 2))
    return out


def augment(x: torch.Tensor, params: np.ndarray, mean, std) -> torch.Tensor:
    """NHWC f32 pixels -> flipped (``p[0] > 0``), then cyclically shifted
    by ``(p[1], p[2])`` rows and columns, then normalized, in f32."""
    b, h, w, _ = x.shape
    p = torch.as_tensor(params, device=x.device).long()
    ys = (torch.arange(h, device=x.device)[None] - p[:, 1:2]) % h
    xs = (torch.arange(w, device=x.device)[None] - p[:, 2:3]) % w
    xs = torch.where(p[:, 0:1] > 0, w - 1 - xs, xs)
    out = x[torch.arange(b, device=x.device)[:, None, None],
            ys[:, :, None], xs[:, None, :]]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (out - mean) * (1.0 / std)


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, prec: Precision):
    ph = _same(x.shape[2], w.shape[2], stride)
    pw = _same(x.shape[3], w.shape[3], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(prec(x), prec(w), stride=stride)


def _bn(x, scale, bias, relu, residual=None):
    """Train-mode BN of an NCHW bf16 activation: (y bf16, mean, var)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = (x32 - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + BN_EPS) * scale
    y = x32 * inv[None, :, None, None] + (bias - mean * inv)[None, :, None,
                                                            None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = F.relu(y)
    return y.to(BF16), mean.detach(), var.detach()


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, labels,
            model: Dict, prec: Precision):
    """(mean cross entropy, {site: (mean, var)}) of normalized NHWC f32
    images; ``p`` holds bf16 leaves."""
    stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def bn(x, name, relu, residual=None):
        y, mu, var = _bn(x, p[f"{name}/scale"].float(),
                         p[f"{name}/bias"].float(), relu, residual)
        stats[name] = (mu, var)
        return y

    x = images.to(BF16).permute(0, 3, 1, 2)
    x = bn(_conv(x, p["stem/conv"], 2, prec), "stem/bn", True)
    ph, pw = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                           value=float("-inf")), 3, 2)
    for si, bi, _, _, _, stride in blocks(model):
        pre = f"stage{si}/block{bi}"
        if bi == 0:
            sc = bn(_conv(x, p[f"{pre}/proj"], stride, prec),
                    f"{pre}/proj_bn", False)
        else:
            sc = x
        h = bn(_conv(x, p[f"{pre}/conv1"], 1, prec), f"{pre}/bn1", True)
        h = bn(_conv(h, p[f"{pre}/conv2"], stride, prec), f"{pre}/bn2", True)
        x = bn(_conv(h, p[f"{pre}/conv3"], 1, prec), f"{pre}/bn3", True,
               residual=sc)
    feat = x.mean(dim=(2, 3))
    logits = (prec(feat) @ prec(p["fc/w"]) + p["fc/b"]).float()
    loss = F.cross_entropy(logits, labels.long())
    return loss, stats


class Task:
    """The reference's view of one training cell of this family."""

    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.model = cfg["model"]
        self.leaves = leaf_specs(self.model)

    def inputs(self, batch: Dict, step: int, device, seed: int):
        """One worker's batch as the step sees it: augmented and
        normalized images (f32) and labels."""
        inp = self.cfg["input"]
        x = torch.as_tensor(batch["images"]).to(device)
        if inp["augment"]:
            table = augment_params(seed, step, batch["global_rows"],
                                   inp["max_shift"])
            lo = batch["row_offset"]
            x = augment(x, table[lo:lo + x.shape[0]], inp["mean"],
                        inp["std"])
        else:
            mean = torch.tensor(inp["mean"], device=device)
            x = (x - mean) * (1.0 / torch.tensor(inp["std"], device=device))
        return x, torch.as_tensor(batch["labels"]).to(device)

    def loss(self, p, inputs, prec: Precision):
        """(loss to differentiate, reported loss, BN statistics)."""
        images, labels = inputs
        loss, stats = forward(p, images, labels, self.model, prec)
        return loss, loss.detach(), stats
