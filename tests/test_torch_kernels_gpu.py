"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused-BN kernels, the stream-LARS segment norms, and bitwise
the fused update, the LARS update, the wire cast and the fused input. Every test here is marked ``gpu`` and skips
without a CUDA device. The file imports neither jax nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Tolerances: f32 outputs rtol/atol 1e-5 (FMA contraction and reduction
order); bf16 outputs rtol 1e-2 / atol 2e-2 (one bf16 ulp where the f32
values before rounding differ in their last bits); sums rtol 1e-4; the
segment norms rtol 1e-5 of a float64 sum of the same inputs, and the
same bits on every run.
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


# ---------------------------------------------------------------------------
# the fused update, the wire cast and the fused input: bitwise against
# their plain versions (every operation rounded once, in the same order)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("wd", ["none", "scalar", "stream"])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_hybrid_update_bitwise_on_card(cuda, n, wd):
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    g = torch.Generator().manual_seed(n)
    grad = torch.randn(n, generator=g) * 1e-2
    p, d = torch.randn(n, generator=g), torch.randn(n, generator=g) * 1e-3
    m = torch.rand(n, generator=g) * 1e-4
    wds = (torch.rand(n, generator=g) < 0.5).float() * 1e-4
    gc = grad.to(cuda)
    dec = {"none": 0.0, "scalar": 1e-4, "stream": wds.to(cuda)}[wd]
    for a_sgd in (0.0, 0.5, 1.0):
        h = HybridHyper(eta=0.05, alpha_sgd=a_sgd)
        kern = [t.to(cuda) for t in (p, d, m)]
        plain = [t.to(cuda) for t in (p, d, m)]
        fu.reset_launch_counts()
        fu.fused_hybrid_update(gc, *kern, h, dec)
        fu.PLAIN["hybrid_update"](gc, *plain, h, dec)
        torch.cuda.synchronize()
        assert fu.LAUNCHES == {"hybrid_update": 1, "seg_sq_partials": 0,
                               "lars_update": 0}
        assert all(torch.equal(a, b) for a, b in zip(kern, plain))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 25_557_032])
def test_cast_copy_bitwise_on_card(cuda, n):
    from repro_torch.kernels import bucket_ops as bo
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(cuda)
    for wire in (torch.bfloat16, torch.float16):
        packed = bo.pack_cast(x, wire)
        assert torch.equal(packed, x.to(wire))
        assert torch.equal(bo.unpack_cast(packed), packed.float())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_input_bitwise_on_card(cuda, dt):
    from repro_torch.kernels import fused_input as fi
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 224, 224, 3, generator=g).to(cuda)
    table = torch.from_numpy(fi.input_augment_params(0, 3, 32)).to(cuda)
    table[:4] = torch.tensor([[1, 4, -4, 0], [0, -4, 4, 0], [1, 0, 0, 0],
                              [0, 0, 0, 0]], dtype=torch.int32)
    mean = torch.tensor([0.1, -0.2, 0.3], device=cuda)
    inv = 1.0 / torch.tensor([0.9, 1.1, 1.3], device=cuda)
    tdt = DTYPES[dt]
    assert torch.equal(
        fi.fused_input_train(x, table, mean, inv, out_dtype=tdt),
        fi.PLAIN["input_train"](x, table, mean, inv, tdt))
    assert torch.equal(fi.fused_input_eval(x, mean, inv, out_dtype=tdt),
                       fi.PLAIN["input_eval"](x, mean, inv, tdt))


# ---------------------------------------------------------------------------
# stream-LARS: segment norms (float64 reference, repeatable) and the
# update (bitwise)
# ---------------------------------------------------------------------------

# segment sizes: an empty segment, 1-element segments, one spanning the
# kernels' 4,096-element chunks, a total that is not a multiple of 128
SEGMENT_SIZES = {
    "edges": [1, 0, 1, 1, 5000, 4095, 1, 8193, 3],
    "one": [1],
    "stream": [2_359_296, 512, 512, 1_048_576, 2048, 2048, 7],
}


def _stream(cuda, sizes, seed):
    g = torch.Generator().manual_seed(seed)
    n = sum(sizes)
    seg = torch.repeat_interleave(torch.arange(len(sizes), dtype=torch.int32),
                                  torch.tensor(sizes))
    p, grad = torch.randn(n, generator=g), torch.randn(n, generator=g) * 1e-2
    wd = (torch.rand(n, generator=g) < 0.5).float() * 1e-4
    return [t.to(cuda) for t in (p, grad, wd, seg)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SEGMENT_SIZES))
def test_seg_sq_partials_on_card(cuda, case):
    from repro_torch.kernels import fused_update as fu
    sizes = SEGMENT_SIZES[case]
    p, g, wd, seg = _stream(cuda, sizes, len(sizes))
    fu.reset_launch_counts()
    got = fu.fused_segment_sq_partials(p, g, wd, seg, len(sizes))
    again = fu.fused_segment_sq_partials(p, g, wd, seg, len(sizes))
    torch.cuda.synchronize()
    assert fu.LAUNCHES["seg_sq_partials"] == 2
    assert torch.equal(got, again)
    p64 = p.double()
    ge = (g + wd * p).double()
    want = torch.zeros(2, len(sizes), dtype=torch.float64, device=cuda)
    want[0].index_add_(0, seg.long(), p64 * p64)
    want[1].index_add_(0, seg.long(), ge * ge)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)
    plain = fu.PLAIN["seg_sq_partials"](p, g, wd, seg, len(sizes))
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
    assert torch.equal(plain, fu.PLAIN["seg_sq_partials"](p, g, wd, seg,
                                                          len(sizes)))
    # ids in any order give the same sums
    perm = torch.randperm(p.numel(), device=cuda)
    shuffled = fu.fused_segment_sq_partials(p[perm], g[perm], wd[perm],
                                            seg[perm], len(sizes))
    torch.testing.assert_close(shuffled.double(), want, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SEGMENT_SIZES))
def test_lars_update_bitwise_on_card(cuda, case):
    from repro_torch.kernels import fused_update as fu
    sizes = SEGMENT_SIZES[case]
    p, g, wd, seg = _stream(cuda, sizes, 7 + len(sizes))
    d = torch.randn(p.shape, device=cuda) * 1e-3
    trust = torch.rand(len(sizes), device=cuda) * 1e-2
    trust[::2] = 1.0  # masked segments
    kern, plain = [p.clone(), d.clone()], [p.clone(), d.clone()]
    fu.reset_launch_counts()
    fu.fused_lars_update(g, *kern, wd, seg, trust, 0.37, 0.9)
    fu.PLAIN["lars_update"](g, *plain, wd, seg, trust, 0.37, 0.9)
    torch.cuda.synchronize()
    assert fu.LAUNCHES["lars_update"] == 1
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
