"""The arithmetic of the bf16 tensor-core flash kernel
(``csrc/flash_attention.cu`` ``flash_fwd_tc``), emulated on the CPU and
held against the plain version (``_flash_attention_plain``) under the
card test's bf16 check: within one bf16 ulp beyond f32 rtol 1e-5 /
atol 1e-6.

The tensor cores take p in bf16, where the plain version keeps it in
f32. The kernel splits p into bf16 terms (``hi = bf16(p)``, ``mid =
bf16(p - hi)``, ``lo = bf16(p - hi - mid)``) and adds their products
with v, smallest first. The emulation does the same steps in the same
order: f32 scores of bf16 inputs, the scale after the dot, online
softmax over 64-key tiles of 64-row q tiles (skipping the tiles the
kernel skips), each tile's p.v summed apart and added to the running
sum in f32, and one rounding of the output to bf16. Two terms (p to
~2^-17) and the kernel's three hold the check on these 524,288 outputs;
on the card two terms put about one output in a million beyond it
(``flash_variants.py``), so the kernel takes three. A single term (p
rounded to bf16 alone) breaks the check: that is why the split is there.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

TILE = 64  # q rows per block and keys per k tile, as in the kernel


def _split(p, terms):
    """p as ``terms`` bf16 values (as f32), largest first, each the bf16
    rounding of what the earlier ones leave."""
    parts = []
    for _ in range(terms):
        parts.append(p.bfloat16().float())
        p = p - parts[-1]
    return parts


def _emulate(q, k, v, causal, window, terms):
    """Attention of bf16 q (B, Sq, Hq, Dh) over k, v (B, Sk, Hkv, Dh) in
    the kernel's arithmetic, p split into ``terms`` bf16 terms (1: p
    rounded to bf16 alone)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    kf = k.float().repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    out = torch.empty(b, hq, sq, dh)
    for q_lo in range(0, sq, TILE):
        q_last = min(q_lo + TILE, sq) - 1
        qpos = torch.arange(q_lo, q_last + 1)[:, None]
        qt = q[:, q_lo:q_last + 1].float().transpose(1, 2)  # (B, H, R, Dh)
        m = torch.full(qt.shape[:3], tfa.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k_lo in range(0, sk, TILE):
            if causal and k_lo > q_last:
                continue
            if window is not None and q_lo - (k_lo + TILE - 1) >= window:
                continue
            k_hi = min(k_lo + TILE, sk)
            kpos = torch.arange(k_lo, k_hi)[None, :]
            s = (qt @ kf[:, :, k_lo:k_hi].transpose(-1, -2)) * scale
            keep = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= qpos - kpos < window
            s = torch.where(keep, s, torch.tensor(tfa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            pv = torch.zeros_like(acc)
            for part in reversed(_split(p, terms)):  # smallest first
                pv = pv + part @ vf[:, :, k_lo:k_hi]
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q_lo:q_last + 1] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


def _beyond_one_ulp(got, want, rtol=1e-5, atol=1e-6):
    """Elements where |got - want| exceeds one bf16 ulp of want + atol +
    rtol * |want| (the card test's bf16 check)."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got - want).abs() > ulp + atol + rtol * want.abs()


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(15)
    return [torch.from_numpy(rng.standard_normal((1, 1024, h, 64))
                             .astype(np.float32)).bfloat16()
            for h in (8, 2, 2)]


MASKS = {"causal": (True, None), "window256": (True, 256)}


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_split_p_holds_the_bf16_check(qkv, mask, terms):
    causal, window = MASKS[mask]
    want = tfa._flash_attention_plain(*qkv, causal, window)
    got = _emulate(*qkv, causal, window, terms)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    bad = _beyond_one_ulp(got, want)
    assert not bool(bad.any()), int(bad.sum())


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_single_bf16_p_breaks_the_bf16_check(qkv, mask):
    causal, window = MASKS[mask]
    want = tfa._flash_attention_plain(*qkv, causal, window)
    got = _emulate(*qkv, causal, window, terms=1)
    assert bool(_beyond_one_ulp(got, want).any())
