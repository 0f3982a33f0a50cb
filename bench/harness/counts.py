"""The benchmark's own count of the work in one training step, from the
layer shapes of the configuration and the traffic: the model FLOPs
behind ``mfu.*`` and the least bytes behind each ``*_roofline``. Counted
from the function's definition, never from how the program implements
it, so a program that fuses or splits kernels is judged on the same
work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def resnet_convs(model: Dict) -> List[Tuple[int, int, int, int]]:
    """(output pixels per image, C_in, C_out, k) of every convolution,
    the fc as a 1x1 convolution of one pixel last."""
    w, size = model["conv_width"], model["image_size"]
    size = _same_out(size, 2)
    out = [(size * size, 3, w, 7)]
    size = _same_out(size, 2)  # the 3x3/2 max-pool
    c_in = w
    for si, n in enumerate(model["conv_stages"]):
        mid = w * 2 ** si
        for bi in range(n):
            stride = 2 if bi == 0 and si > 0 else 1
            o = _same_out(size, stride)
            out.append((size * size, c_in, mid, 1))
            out.append((o * o, mid, mid, 3))
            out.append((o * o, mid, mid * 4, 1))
            if bi == 0:
                out.append((o * o, c_in, mid * 4, 1))
            size, c_in = o, mid * 4
    out.append((1, c_in, model["num_classes"], 1))
    return out


def resnet_step_flops(model: Dict, batch: int) -> float:
    """Forward x 3: every convolution and the fc, 2 FLOPs a
    multiply-add."""
    fwd = sum(2 * px * ci * co * k * k for px, ci, co, k in
              resnet_convs(model))
    return 3.0 * fwd * batch


def resnet_bn_sites(model: Dict, batch: int
                    ) -> List[Tuple[int, int, bool, bool]]:
    """(rows, channels, ReLU, residual) of every BN site."""
    w, size = model["conv_width"], _same_out(model["image_size"], 2)
    sites = [(batch * size * size, w, True, False)]
    size = _same_out(size, 2)
    for si, n in enumerate(model["conv_stages"]):
        mid = w * 2 ** si
        for bi in range(n):
            stride = 2 if bi == 0 and si > 0 else 1
            o = _same_out(size, stride)
            if bi == 0:
                sites.append((batch * o * o, mid * 4, False, False))
            sites += [(batch * size * size, mid, True, False),
                      (batch * o * o, mid, True, False),
                      (batch * o * o, mid * 4, True, True)]
            size = o
    return sites


def bn_site_bytes(rows: int, c: int, relu: bool, residual: bool,
                  esize: int = 2) -> float:
    """Least bytes of one train-mode BN site, forward and backward.
    Forward: x (and the residual) read once, y written once, the scale
    and bias read and the batch mean and variance written (f32).
    Backward: x, dy and, under a ReLU, its mask's input y read once, dx
    (and the residual's gradient) written once, the scale, mean and
    variance read and the scale's and bias's gradients written (f32)."""
    act = rows * c * esize
    fwd = act * (2 + residual) + 4 * c * 4
    bwd = act * (2 + relu + 1 + residual) + 5 * c * 4
    return float(fwd + bwd)


def resnet_bn_bytes(model: Dict, batch: int) -> float:
    return sum(bn_site_bytes(*s) for s in resnet_bn_sites(model, batch))


def mixtral_step_flops(model: Dict, batch: int, seq: int) -> float:
    """Forward x 3 over ``batch`` rows of ``seq`` tokens: attention's
    projections and its causal scores (each query against the keys it
    may see, QK^T and PV), the router, the products of the
    ``experts_per_token`` routed experts of every token (SwiGLU: three),
    and the head. Dispatch and combine, capacity padding and dropped
    tokens are not counted."""
    d, h, kv, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    ff, e, k, v = (model["d_ff"], model["n_experts"],
                   model["experts_per_token"], model["vocab_size"])
    window = model.get("sliding_window") or seq
    seen = sum(min(i + 1, window) for i in range(seq))
    per_layer = (seq * 2 * d * dh * (2 * h + 2 * kv)  # q, k, v, o
                 + seen * 2 * dh * h * 2  # QK^T and PV
                 + seq * 2 * d * e  # the router
                 + seq * k * 3 * 2 * d * ff)  # the routed experts
    fwd = model["n_layers"] * per_layer + seq * 2 * d * v
    return 3.0 * fwd * batch


# least bytes per parameter element and step: the hybrid update reads
# the gradient, the parameter, Delta and m (f32) and writes the last
# three; the bf16 wire casts the f32 gradient to bf16 and back
UPDATE_BYTES = 4 * 4 + 3 * 4
WIRE_CAST_BYTES = (4 + 2) + (2 + 4)


def update_bytes(n_elements: int) -> float:
    return float(n_elements * (UPDATE_BYTES + WIRE_CAST_BYTES))


def step_flops(cfg: Dict, mix: Dict) -> float:
    model = cfg["model"]
    if model["family"] == "conv":
        return resnet_step_flops(model, mix["batch"])
    return mixtral_step_flops(model, mix["batch"], mix["seq_len"])
