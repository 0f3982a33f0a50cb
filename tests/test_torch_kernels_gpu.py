"""The port's CUDA fused-BN kernels against their plain PyTorch versions,
on the card. Every test here is marked ``gpu`` and skips without a CUDA
device. The file imports neither jax nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Tolerances: f32 outputs rtol/atol 1e-5 (FMA contraction and reduction
order); bf16 outputs rtol 1e-2 / atol 2e-2 (one bf16 ulp where the f32
values before rounding differ in their last bits); sums rtol 1e-4.
"""
import pytest
import torch

from repro_torch.kernels import fused_bn as tfb

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,c", [(1, 64), (333, 40), (100352, 64),
                                    (1568, 2048)])
def test_kernels_match_plain_on_card(cuda, rows, c, dt):
    tdt = DTYPES[dt]
    g = torch.Generator().manual_seed(rows + c)

    def rnd(*shape, dtype=tdt):
        return (torch.randn(*shape, generator=g) * 2 + 0.5).to(dtype)

    x, r, dy = rnd(rows, c), rnd(rows, c), rnd(rows, c)
    a, o = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=1e-2, atol=2e-2)
    tfb.reset_launch_counts()
    m, v = tfb.bn_stats(x.to(cuda))
    pm, pv = tfb.bn_stats(x)
    torch.testing.assert_close(m.cpu(), pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v.cpu(), pv, rtol=1e-4, atol=1e-5)
    for relu in (False, True):
        y = tfb.bn_apply(x.to(cuda), a.to(cuda), o.to(cuda), r.to(cuda),
                         relu)
        py = tfb.bn_apply(x, a, o, r, relu)
        torch.testing.assert_close(y.cpu().float(), py.float(), **tol)
        rstd = torch.rsqrt(pv + 1e-5)
        s1, s2 = tfb.bn_bwd_sums(dy.to(cuda), x.to(cuda), py.to(cuda),
                                 pm.to(cuda), rstd.to(cuda), relu)
        p1, p2 = tfb.bn_bwd_sums(dy, x, py, pm, rstd, relu)
        torch.testing.assert_close(s1.cpu(), p1, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(s2.cpu(), p2, rtol=1e-4, atol=1e-3)
        dx, dr = tfb.bn_bwd_dx(dy.to(cuda), x.to(cuda), py.to(cuda),
                               pm.to(cuda), rstd.to(cuda), a.to(cuda),
                               o.to(cuda), a.to(cuda), relu, True)
        pdx, pdr = tfb.bn_bwd_dx(dy, x, py, pm, rstd, a, o, a, relu, True)
        torch.testing.assert_close(dx.cpu().float(), pdx.float(), **tol)
        torch.testing.assert_close(dr.cpu(), pdr, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert tfb.LAUNCHES == {"bn_stats": 1, "bn_apply": 2, "bn_bwd_sums": 2,
                            "bn_bwd_dx": 2}


@pytest.mark.gpu
def test_reductions_are_bitwise_repeatable_on_card(cuda):
    x = torch.randn(100352, 64, device=cuda, dtype=torch.bfloat16)
    first = tfb.bn_stats(x)
    for _ in range(3):
        again = tfb.bn_stats(x)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
