"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused-BN kernels, the stream-LARS segment norms, flash
attention and RMSNorm, and bitwise the fused update, the LARS update,
the wire cast and the fused input; checkpoints (a bitwise resume, a card
checkpoint restored on the CPU) and the sentinel's skip on the DP path.
Every test here is marked ``gpu`` and skips
without a CUDA device. The file imports neither jax nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py

Tolerances: ``bn_apply`` and ``bn_bwd_dx`` bitwise (each op rounded
once, in the plain version's order; ``bn_bwd_dx`` against its plain
version on the CPU too, which forms B and C with the same reciprocal
1 / m); the other f32 outputs rtol/atol 1e-5 (FMA contraction
and reduction order); bf16 outputs rtol 1e-2 / atol 2e-2 (one bf16 ulp
where the f32 values before rounding differ in their last bits); sums
rtol 1e-4; the
segment norms rtol 1e-5 of a float64 sum of the same inputs, and the
same bits on every run; flash attention f32 rtol 1e-5 / atol 1e-6 (its
sums run in another order than the plain full softmax), RMSNorm f32
rtol 1e-6 (the row sum's order moves inv by an ulp); in bf16, beyond
those, flash within one bf16 ulp and RMSNorm within two (it rounds
twice, x * inv and then the product with the scale, so a flip of the
first rounding moves the second product by up to ~2 ulps), in either
rounding order; gradients through the LM kernels' autograd Functions
bitwise against the plain versions' own autograd (the backward is that
same recompute).
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
                                    (1568, 2048), (777, 100)])
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
        assert torch.equal(y.cpu(), py)
        rstd = torch.rsqrt(pv + 1e-5)
        s1, s2 = tfb.bn_bwd_sums(dy.to(cuda), x.to(cuda), py.to(cuda),
                                 pm.to(cuda), rstd.to(cuda), relu)
        p1, p2 = tfb.bn_bwd_sums(dy, x, py, pm, rstd, relu)
        torch.testing.assert_close(s1.cpu(), p1, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(s2.cpu(), p2, rtol=1e-4, atol=1e-3)
        dx, dr = tfb.bn_bwd_dx(dy.to(cuda), x.to(cuda), py.to(cuda),
                               pm.to(cuda), rstd.to(cuda), a.to(cuda),
                               p1.to(cuda), p2.to(cuda), None, None,
                               1.0 / rows, relu, True)
        pdx, pdr = tfb.bn_bwd_dx(dy, x, py, pm, rstd, a, p1, p2, None, None,
                                 1.0 / rows, relu, True)
        assert torch.equal(dx.cpu(), pdx)
        assert torch.equal(dr.cpu(), pdr)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bn_stats_unaligned_rows_on_card(cuda, dt):
    """x starting 2 elements into its buffer takes the scalar path of the
    same kernel; repeated launches (the self-resetting merge counters)
    give the same bits."""
    rows, c = 6272, 256
    buf = torch.randn(rows * c + 2, generator=torch.Generator().manual_seed(
        5)).to(DTYPES[dt])
    xc = buf.to(cuda)[2:].view(rows, c)
    assert xc.data_ptr() % 16 != 0
    m, v = tfb.bn_stats(xc)
    pm, pv = tfb.bn_stats(buf[2:].view(rows, c))
    torch.testing.assert_close(m.cpu(), pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v.cpu(), pv, rtol=1e-4, atol=1e-5)
    again = tfb.bn_stats(xc)
    assert torch.equal(again[0], m) and torch.equal(again[1], v)


def _dx_case(rows, c, dt, seed):
    """(dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar) of one ReLU BN
    site on the CPU, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, dtype=DTYPES[dt]):
        return (torch.randn(*shape, generator=g) * 2 + 0.5).to(dtype)

    x, dy = rnd(rows, c), rnd(rows, c)
    scale, bias = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
    mu, var = tfb.bn_stats(x)
    rstd = torch.rsqrt(var + 1e-5)
    a = rstd * scale
    y = tfb.bn_apply(x, a, bias - mu * a, relu=True)
    s1, s2 = tfb.bn_bwd_sums(dy, x, y, mu, rstd, True)
    return (dy, x, y, mu, rstd, scale, s1, s2, rnd(c, dtype=torch.float32),
            rnd(c, dtype=torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["offset dy", "bf16 C=100", "cotangents",
                                  "given stats", "unaligned channel vectors"])
def test_bn_bwd_dx_bitwise_on_card(cuda, case):
    """``bn_bwd_dx`` (dx and dres) bitwise against its plain version on
    the CPU: a dy view 1 element into its buffer and C = 100 in bf16
    (the scalar path), non-zero mean / var cotangents, given-stats mode
    (s1 = s2 = None), and per-channel vectors 1 element into theirs
    (read with scalar loads on the vector path)."""
    dt = "bf16" if case == "bf16 C=100" else "f32"
    rows, c = (777, 100) if case == "bf16 C=100" else (6272, 256)
    dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar = _dx_case(rows, c, dt,
                                                              11)
    if case != "cotangents":
        dmean = dvar = None
    if case == "given stats":
        s1 = s2 = None
    cpu = (dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar)
    dev = [None if t is None else t.to(cuda) for t in cpu]
    if case == "offset dy":
        buf = torch.empty(rows * c + 1, dtype=dy.dtype, device=cuda)
        dev[0] = buf[1:].view(rows, c)
        dev[0].copy_(dy)
        assert dev[0].data_ptr() % 16 != 0
    if case == "unaligned channel vectors":
        for i in (3, 4, 5):
            buf = torch.empty(c + 1, device=cuda)
            buf[1:].copy_(cpu[i])
            dev[i] = buf[1:]
    want = tfb.bn_bwd_dx(*cpu, 1.0 / rows, True, True)
    got = tfb.bn_bwd_dx(*dev, 1.0 / rows, True, True)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_bn_bwd_dx_global_count_bitwise_on_card(cuda, k, dt):
    """``bn_bwd_dx`` with the count of a k-worker cross-replica site (k x
    rows, and inv_m = 1 / that) and non-zero mean / var cotangents,
    bitwise against its plain version on the card and on the CPU."""
    rows, c = 6272, 256
    cpu = _dx_case(rows, c, dt, 14 + k)
    dev = [t.to(cuda) for t in cpu]
    m = k * rows
    want = tfb.bn_bwd_dx(*cpu, 1.0 / m, True, True, count=m)
    plain = tfb.PLAIN["bn_bwd_dx"](*dev, 1.0 / m, True, True, count=m)
    got = tfb.bn_bwd_dx(*dev, 1.0 / m, True, True, count=m)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p) and torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("relu,res", [(False, False), (True, True)])
def test_sync_train_fn_at_world_size_one_is_bitwise_on_card(dp_card, relu,
                                                           res):
    """The cross-replica ``_TrainFn`` over a group of one (NCCL): its
    outputs and every gradient, with and without mean / var cotangents,
    are the bits of the plain ``_TrainFn``'s."""
    import torch.distributed as dist

    from repro_torch.kernels import ops as tops
    g = torch.Generator().manual_seed(15)
    shape = (8, 14, 14, 128)
    base = [torch.randn(shape, generator=g).bfloat16(),
            1 + 0.1 * torch.randn(128, generator=g),
            0.1 * torch.randn(128, generator=g),
            torch.randn(shape, generator=g).bfloat16() if res else None]
    cts = [torch.randn(shape, generator=g).bfloat16().to("cuda"),
           torch.randn(128, generator=g).to("cuda"),
           torch.randn(128, generator=g).to("cuda")]
    runs = []
    for group in (dist.group.WORLD, None):
        ins = [None if t is None else t.to("cuda").requires_grad_(True)
               for t in base]
        outs = tops.fused_bn_train(ins[0], ins[1], ins[2], residual=ins[3],
                                   relu=relu, group=group)
        leaves = [t for t in ins if t is not None]
        full = torch.autograd.grad(outs, leaves, cts, retain_graph=True)
        only_y = torch.autograd.grad(outs[0], leaves, cts[0])
        runs.append([t.detach() for t in outs] + list(full) + list(only_y))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bn_bwd_dx_in_a_cuda_graph_on_card(cuda):
    """A capture of ``bn_bwd_dx`` (no allocation beyond its outputs, no
    synchronisation), replayed, gives the eager result's bits."""
    args = [t.to(cuda) for t in _dx_case(100352, 64, "bf16", 12)]
    eager = tfb.bn_bwd_dx(*args, 1.0 / 100352, True, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfb.bn_bwd_dx(*args, 1.0 / 100352, True, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfb.bn_bwd_dx(*args, 1.0 / 100352, True, True)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.gpu
@pytest.mark.parametrize("relu,res", [(False, False), (True, True)])
def test_train_backward_is_three_kernels_on_card(cuda, relu, res):
    """One train-mode site's backward with mean / var detached launches
    ``bn_bwd_sums``' two kernels and one ``bn_bwd_dx``, and no other
    kernel (torch.profiler); its dx and dres are the plain version's
    bits given the same sums, and dscale / dbias are the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as tops
    g = torch.Generator().manual_seed(13)
    shape = (32, 28, 28, 64)
    x = torch.randn(shape, generator=g).bfloat16().to(cuda)
    dy = torch.randn(shape, generator=g).bfloat16().to(cuda)
    r = torch.randn(shape, generator=g).bfloat16().to(cuda) if res else None
    scale = (1 + 0.1 * torch.randn(64, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(64, generator=g)).to(cuda)
    leaves = [t.requires_grad_(True) for t in (x, scale, bias, r)
              if t is not None]
    y, mean, var = tops.fused_bn_train(x, scale, bias, residual=r,
                                       relu=relu)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
    ours = ("dx_kernel", "sums_merge", "sums_partial")
    names = sorted(next((k for k in ours if k in e.key), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   for _ in range(e.count))
    assert names == list(ours), names
    x2, y2, dy2 = (t.detach().view(-1, 64) for t in (x, y, dy))
    rstd = torch.rsqrt(var + 1e-5)
    s1, s2 = tfb.bn_bwd_sums(dy2, x2, y2, mean, rstd, relu)
    want = tfb.PLAIN["bn_bwd_dx"](dy2, x2, y2, mean, rstd, scale.detach(),
                                  s1, s2, None, None, 1.0 / x2.shape[0],
                                  relu, res)
    assert torch.equal(got[0].view(-1, 64), want[0])
    assert torch.equal(got[1], s2) and torch.equal(got[2], s1)
    if res:
        assert torch.equal(got[3].view(-1, 64), want[1])


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


# ResNet-50's 25,557,032-element stream over 2 ZeRO workers (no pad)
ZERO_SHARD = 12_778_516


@pytest.mark.gpu
def test_hybrid_update_decay_stream_at_the_zero_shard_bitwise_on_card(cuda):
    """ZeRO's update (``optim/stream.py``, ``--use-fused-kernel``): one
    launch of the decay-stream entry over a worker's shard, bitwise its
    plain version; the decay is 0 on runs of no-decay elements."""
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    g = torch.Generator().manual_seed(11)
    n = ZERO_SHARD
    grad = (torch.randn(n, generator=g) * 1e-2).to(cuda)
    p, d = torch.randn(n, generator=g), torch.randn(n, generator=g) * 1e-3
    m = torch.rand(n, generator=g) * 1e-4
    runs = (torch.rand(n // 512 + 1, generator=g) < 0.3).repeat_interleave(
        512)[:n]  # no-decay leaves: runs of elements
    wd = torch.where(runs, 0.0, 5e-5).to(cuda)
    h = HybridHyper(eta=0.05, alpha_sgd=0.5)
    kern = [t.to(cuda) for t in (p, d, m)]
    plain = [t.to(cuda) for t in (p, d, m)]
    fu.reset_launch_counts()
    fu.fused_hybrid_update(grad, *kern, h, wd)
    fu.PLAIN["hybrid_update"](grad, *plain, h, wd)
    torch.cuda.synchronize()
    assert fu.ENTRY_LAUNCHES == {"hybrid_update": 1,
                                 "hybrid_update_leaves": 0,
                                 "seg_sq_partials": 0, "lars_update": 0}
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))


# leaf sizes of the multi-leaf update: one element, BN vectors, odd
# lengths, a leaf of several chunks, one past a chunk edge
LEAF_SIZES = [1, 64, 1000, 108, 2048, 4097, 65_543, 1_000_003, 8193]


def _leaves(cuda, offset, seed):
    """g as views ``offset`` elements into one stream (as ``unpack`` gives
    the gradients), p, d and m each its own tensor."""
    g = torch.Generator().manual_seed(seed)
    flat = (torch.randn(offset + sum(LEAF_SIZES), generator=g)
            * 1e-2).to(cuda)
    bounds = torch.tensor([0] + LEAF_SIZES).cumsum(0).tolist()
    gs = [flat[offset + lo:offset + hi] for lo, hi in zip(bounds, bounds[1:])]
    states = [(torch.randn(n, generator=g), torch.randn(n, generator=g)
               * 1e-3, torch.rand(n, generator=g) * 1e-4) for n in LEAF_SIZES]
    return gs, states


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_hybrid_update_leaves_bitwise_on_card(cuda, offset):
    """Every leaf in one launch, bitwise equal to the plain version leaf
    by leaf, with the gradients 0, 1 or 2 elements into one stream (the
    vector path, and the scalar path where g's alignment differs from
    p's)."""
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    gs, states = _leaves(cuda, offset, seed=offset)
    wds = [1e-4 if i % 3 else 0.0 for i in range(len(gs))]
    for a_sgd in (0.0, 0.5, 1.0):
        h = HybridHyper(eta=0.05, alpha_sgd=a_sgd)
        kern = [[s[j].to(cuda) for s in states] for j in range(3)]
        plain = [[s[j].to(cuda) for s in states] for j in range(3)]
        fu.reset_launch_counts()
        fu.fused_hybrid_update_leaves(gs, *kern, h, wds)
        assert fu.LAUNCHES == {"hybrid_update": 1, "seg_sq_partials": 0,
                               "lars_update": 0}
        for i, g in enumerate(gs):
            fu.PLAIN["hybrid_update"](g, plain[0][i], plain[1][i],
                                      plain[2][i], h, wds[i])
        torch.cuda.synchronize()
        for ka, pa in zip(kern, plain):
            assert all(torch.equal(a, b) for a, b in zip(ka, pa))


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["bf16 g", "strided p", "shape m"])
def test_hybrid_update_leaves_raises_on_bad_leaf(cuda, how):
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    gs, states = _leaves(cuda, 0, seed=9)
    ps, ds, ms = ([s[j].to(cuda) for s in states] for j in range(3))
    if how == "bf16 g":
        gs[2] = gs[2].to(torch.bfloat16)
    elif how == "strided p":
        ps[2] = torch.randn(2 * LEAF_SIZES[2], device=cuda)[::2]
    else:
        ms[2] = ms[2][:-1]
    fu.reset_launch_counts()
    with pytest.raises(ValueError, match="leaf 2's"):
        fu.fused_hybrid_update_leaves(gs, ps, ds, ms,
                                      HybridHyper(eta=0.05, alpha_sgd=0.5),
                                      [0.0] * len(gs))
    assert fu.LAUNCHES["hybrid_update"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 127, 8 * 4099 + 3, 25_557_032])
def test_cast_copy_bitwise_on_card(cuda, n):
    from repro_torch.kernels import bucket_ops as bo
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(cuda)
    for wire in (torch.bfloat16, torch.float16):
        packed = bo.pack_cast(x, wire)
        assert torch.equal(packed, x.to(wire))
        assert torch.equal(bo.unpack_cast(packed), packed.float())


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_cast_copy_offset_views_bitwise_on_card(cuda, offset):
    """Streams that start 4-20 bytes (f32) or 2-10 bytes (half) into
    their buffers: the scalar head, the vector groups and the tail, or
    the scalar path where no head aligns both pointers."""
    from repro_torch.kernels import bucket_ops as bo
    n = 8 * 1000 + 5
    buf = torch.randn(n + offset, generator=torch.Generator().manual_seed(
        offset)).to(cuda) * 3
    x = buf[offset:]
    for wire in (torch.bfloat16, torch.float16):
        packed = bo.pack_cast(x, wire)
        assert torch.equal(packed, x.to(wire))
        half = packed.new_empty(n + offset)
        half[offset:] = packed
        assert torch.equal(bo.unpack_cast(half[offset:]), packed.float())


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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape,offset", [
    ((2, 7, 5, 3), 0), ((2, 7, 5, 1), 0), ((2, 7, 5, 4), 0),
    ((3, 9, 8, 3), 0), ((3, 9, 8, 3), 1)])
def test_fused_input_edge_shapes_bitwise_on_card(cuda, shape, offset, dt):
    """input_train at shapes whose rows take element or 16-byte access,
    C = 1 and 4, an input 4 bytes off alignment, and shifts of +-W,
    +-(W+1) and +-3H with and without flips (jnp.roll's semantics for
    any shift)."""
    from repro_torch.kernels import fused_input as fi
    b, h, w, c = shape
    rows = [[1, 3 * h, w, 0], [0, -3 * h, -w, 0], [1, h + 1, w + 1, 0],
            [0, -(h + 1), -(w + 1), 0], [1, -3 * h, w + 1, 0],
            [0, 3 * h + 2, -(w + 1), 0]]
    g = torch.Generator().manual_seed(offset)
    buf = torch.randn(offset + b * h * w * c, generator=g).to(cuda) * 50
    x = buf[offset:].view(shape)
    mean = torch.linspace(-1.0, 1.0, c, device=cuda)
    inv = 1.0 / torch.linspace(0.5, 1.5, c, device=cuda)
    tdt = {"f16": torch.float16, **DTYPES}[dt]
    for lo in range(0, len(rows), b):
        table = torch.tensor((rows * b)[lo:lo + b], dtype=torch.int32,
                             device=cuda)
        assert torch.equal(
            fi.fused_input_train(x, table, mean, inv, out_dtype=tdt),
            fi.PLAIN["input_train"](x, table, mean, inv, tdt))


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


def _within_bf16_ulps(got, want, ulps, rtol, atol):
    """|got - want| <= ``ulps`` bf16 ulps of want + atol + rtol * |want|."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = (got - want).abs() > ulps * ulp + atol + rtol * want.abs()
    assert not bool(bad.any()), (got - want).abs().max().item()


# (B, Sq, Sk, Hq, Hkv, Dh, causal, window): the serving path's prefill,
# lengths 1 and 1000, Sq != Sk, non-causal, a causal window of 256,
# groups 1, 4 and 8, Dh 32 and 128, the 64-row tile edges (one row
# past a tile, one short of it, a single key), and Dh 96 and 112 (the
# registry's MHA configs with 32 kv heads) with tile edges of their own
FLASH_CASES = [
    (8, 1024, 1024, 32, 8, 64, True, None),
    (2, 1, 1, 8, 8, 64, True, None),
    (2, 1000, 1000, 32, 8, 64, True, None),
    (2, 300, 1000, 8, 2, 64, True, None),
    (2, 1000, 300, 8, 2, 64, False, None),
    (2, 1024, 1024, 8, 8, 64, False, None),
    (2, 1000, 1000, 16, 4, 64, True, 256),
    (1, 777, 777, 8, 1, 128, True, None),
    (2, 513, 513, 8, 2, 32, True, None),
    (1, 65, 63, 8, 8, 64, True, None),
    (2, 129, 129, 32, 8, 128, True, None),
    (1, 64, 1, 4, 1, 32, False, None),
    (1, 1000, 1000, 32, 32, 96, True, None),
    (1, 1000, 1000, 32, 32, 112, True, None),
    (1, 65, 63, 8, 8, 96, True, None),
    (2, 129, 129, 8, 4, 112, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain_on_card(cuda, case, dt):
    from repro_torch.kernels import flash_attention as tfa
    b, sq, sk, hq, hkv, dh, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq + sk + dh)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda)
               .to(DTYPES[dt]) for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tfa.PLAIN["flash_attention"](q, k, v, causal, window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    if dt == "f32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        _within_bf16_ulps(got, want, 1, 1e-5, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["row_stride", "offset"])
def test_flash_attention_bf16_misaligned_rows_match_aligned_copy(cuda, how):
    from repro_torch.kernels import flash_attention as tfa
    g = torch.Generator(device=cuda).manual_seed(11)
    shape = (2, 130, 4, 64)
    if how == "row_stride":  # rows 136 bytes apart
        views = [torch.randn(2, 130, 4, 68, generator=g, device=cuda)
                 .bfloat16()[..., :64] for _ in range(3)]
    else:  # contiguous, starting 8 bytes into the buffer
        n = 2 * 130 * 4 * 64
        views = [torch.randn(n + 4, generator=g, device=cuda).bfloat16()
                 [4:].view(shape) for _ in range(3)]
    assert not any(tfa._rows_aligned(t) for t in views)
    copies = [t.clone(memory_format=torch.contiguous_format) for t in views]
    tfa.reset_launch_counts()
    got = tfa.flash_attention(*views)
    want = tfa.flash_attention(*copies)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 2}
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_flash_attention_raises_on_other_head_dims_on_card(cuda):
    from repro_torch.kernels import flash_attention as tfa
    q = torch.zeros(1, 8, 2, 80, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,d", [(8192, 2048), (8, 2048), (333, 2048),
                                    (1001, 128), (5, 100)])
def test_rmsnorm_matches_plain_on_card(cuda, rows, d, dt):
    from repro_torch.kernels import rmsnorm as trn
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 2 + 0.3).to(
        DTYPES[dt])
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    trn.reset_launch_counts()
    got = trn.rmsnorm(x, scale)
    want = trn.PLAIN["rmsnorm"](x, scale, 1e-5)
    torch.cuda.synchronize()
    assert trn.LAUNCHES == {"rmsnorm": 1}
    if dt == "f32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        _within_bf16_ulps(got, want, 2, 0.0, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,d", [(8192, 2048), (8, 2048), (5, 100)])
def test_rmsnorm_model_order_matches_plain_on_card(cuda, rows, d, dt):
    """``round_inv=True``, the JAX model's order (``apply_norm``)."""
    from repro_torch.kernels import rmsnorm as trn
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 2 + 0.3).to(
        DTYPES[dt])
    scale = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(
        DTYPES[dt])
    got = trn.rmsnorm(x, scale, round_inv=True)
    want = trn.PLAIN["rmsnorm"](x, scale, 1e-5, True)
    if dt == "f32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        _within_bf16_ulps(got, want, 2, 0.0, 0.0)


def _grads_both_ways(fn, plain, inputs, seed):
    """(outputs, grads) of ``fn`` (through its autograd Function) and of
    ``plain`` (the plain version's own autograd), under the same random
    cotangent."""
    out = []
    for f in (fn, plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = f(*leaves)
        g = torch.Generator(device=y.device).manual_seed(seed)
        dy = torch.randn(y.shape, generator=g, device=y.device).to(y.dtype)
        y.backward(dy)
        out.append((y, [t.grad for t in leaves]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("round_inv", [False, True])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rmsnorm_gradients_on_card(cuda, dt, round_inv):
    from repro_torch.kernels import rmsnorm as trn
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(333, 2048, generator=g, device=cuda) * 2).to(DTYPES[dt])
    scale = 1 + 0.1 * torch.randn(2048, generator=g, device=cuda)
    trn.reset_launch_counts()
    (yk, gk), (yp, gp) = _grads_both_ways(
        lambda a, b: trn.rmsnorm(a, b, round_inv=round_inv),
        lambda a, b: trn.PLAIN["rmsnorm"](a, b, 1e-5, round_inv),
        (x, scale), 4)
    torch.cuda.synchronize()
    assert trn.LAUNCHES == {"rmsnorm": 1} and yk.grad_fn is not None
    for a, b in zip(gk, gp):
        assert a is not None and bool(torch.isfinite(a).all())
        assert bool((a != 0).any()) and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 96])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_gradients_on_card(cuda, dt, dh):
    from repro_torch.kernels import flash_attention as tfa
    g = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = (torch.randn(2, 200, h, dh, generator=g, device=cuda)
               .to(DTYPES[dt]) for h in (8, 2, 2))
    tfa.reset_launch_counts()
    (yk, gk), (yp, gp) = _grads_both_ways(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=True),
        lambda a, b, c: tfa.PLAIN["flash_attention"](a, b, c, True, None),
        (q, k, v), 5)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_attention": 1} and yk.grad_fn is not None
    for a, b in zip(gk, gp):
        assert a is not None and bool(torch.isfinite(a).all())
        assert bool((a != 0).any()) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints and the sentinel on the card (phase 10 / 10b of chip_smoke.py
# at the reduced ResNet): every kernel of the DP path on, cuDNN held to
# deterministic algorithms
# ---------------------------------------------------------------------------


@pytest.fixture
def dp_card(cuda, tmp_path):
    from repro_torch.distributed import init_workers, shutdown
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    init_workers("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    yield tmp_path
    shutdown()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det


def _dp_card_setup(sentinel=False, error_feedback=False):
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.launch.train import build_train_setup
    return build_train_setup(
        reduced_config(get_config("resnet50")), global_batch=16, seq_len=0,
        opt_cfg=OptimizerConfig(), steps_per_epoch=4, dp_mode="shardmap",
        compute_dtype=torch.bfloat16, use_fused_kernel=True,
        compression="bf16+bucketed", fused_bn=True,
        error_feedback=error_feedback, sentinel=sentinel,
        input_cfg=InputConfig(fused=True, num_workers=2), device="cuda")


def _flat_state(state, shardings):
    from repro_torch import interop
    from repro_torch.checkpoint import checkpointer
    return checkpointer._flatten(interop.train_state_to_jax(state,
                                                            shardings))


@pytest.mark.gpu
@pytest.mark.parametrize("error_feedback", [False, True])
def test_resume_bitwise_on_card(dp_card, error_feedback):
    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.training import LoopConfig, run_training
    ckdir = str(dp_card / "ck")

    def run(total, directory=None):
        _, state, step, data, put, sh = _dp_card_setup(
            error_feedback=error_feedback)
        res = run_training(step, state, data,
                           LoopConfig(total_steps=total, checkpoint_every=3,
                                      checkpoint_dir=directory, log_every=1),
                           put_batch=put, state_shardings=sh)
        return res, sh

    ref, sh = run(6)
    run(3, ckdir)
    tfu.reset_launch_counts()
    res, _ = run(6, ckdir)
    torch.cuda.synchronize()
    assert res.resumed_from == 3 and list_checkpoints(ckdir) == [3, 6]
    assert tfu.LAUNCHES["hybrid_update"] == 3
    a, b = _flat_state(ref.state, sh), _flat_state(res.state, sh)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.gpu
def test_sentinel_skips_nan_batch_bitwise_on_card(dp_card):
    import numpy as np

    from repro_torch.resilience import sentinel_controls
    _, state, step, data, put, sh = _dp_card_setup(sentinel=True,
                                                   error_feedback=True)
    state, m = step(state, put(data.batch_at(0)).take(), sentinel_controls())
    assert not m["bad_step"] and state["opt"]["step"] == 1
    before = _flat_state(state, sh)
    batch = dict(data.batch_at(1))
    images = np.array(batch["images"])
    images.reshape(-1)[11] = np.nan
    batch["images"] = images
    state, m = step(state, put(batch).take(), sentinel_controls())
    assert m["bad_step"] and m["nonfinite_step"]
    assert state["opt"]["step"] == 1
    after = _flat_state(state, sh)
    for k in before:
        assert before[k].tobytes() == after[k].tobytes(), k


@pytest.mark.gpu
def test_card_checkpoint_restores_on_the_cpu_bitwise(dp_card):
    from repro_torch import interop
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import (OptimizerConfig, get_config,
                                     reduced_config)
    from repro_torch.launch.train import build_train_setup
    _, state, step, data, put, sh = _dp_card_setup(error_feedback=True)
    for i in range(2):
        state, _ = step(state, put(data.batch_at(i)).take())
    save(str(dp_card / "ck"), 2, interop.train_state_to_jax(state, sh))
    _, cpu_state, *_ = build_train_setup(
        reduced_config(get_config("resnet50")), global_batch=16, seq_len=0,
        opt_cfg=OptimizerConfig(), steps_per_epoch=4, device="cpu")
    arrays, _ = restore(str(dp_card / "ck"))
    interop.train_state_from_jax(arrays, cpu_state, sh)  # worker 0's row
    assert cpu_state["opt"]["step"] == 2
    for name, t in state["params"].items():
        assert torch.equal(cpu_state["params"][name], t.cpu()), name
    for f in ("delta", "m"):
        for name, t in state["opt"][f].items():
            assert torch.equal(cpu_state["opt"][f][name], t.cpu()), name
    for site, rec in state["model_state"].items():
        for k, t in rec.items():
            assert torch.equal(cpu_state["model_state"][site][k], t.cpu())
