"""The port's fused BN (repro_torch/kernels/fused_bn.py) against the JAX
package's fused Pallas BN (repro.kernels.ops, interpret mode on the CPU).

Here on the CPU the port's wrappers run their plain PyTorch versions;
the same numpy inputs go through both sides, forward and every gradient
(dx, dscale, dbias, dres and the mean/var cotangents), over
{identity, ReLU, residual + ReLU} x {f32, bf16}. The CUDA kernels are
held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py`` and by ``chip_smoke.py``.

Tolerances. f32: rtol 1e-5 (both sides compute in f32; only the
reduction order differs). bf16: the outputs are rounded to bf16 on both
sides from f32 values that may differ in the last f32 bits (rsqrt and
reduction order), so an element may land one bf16 ulp apart: rtol 1e-2
(2.6 ulp) with a small atol for elements near zero; dscale/dbias are
rounded to bf16 from f32 sums, the same one-ulp argument.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_bn as jfb
from repro.kernels import ops as jops
from repro_torch.kernels import fused_bn as tfb
from repro_torch.kernels import ops as tops

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EPILOGUES = {"identity": (False, False), "relu": (True, False),
             "res_relu": (True, True)}
SHAPE = (3, 5, 7, 24)  # 105 rows: not a multiple of any block size


def _tol(dt):
    return dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=1e-2, atol=2e-2)


def _inputs(shape, seed, has_res):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return {
        "x": rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5,
        "res": (rng.standard_normal(shape).astype(np.float32)
                if has_res else None),
        "scale": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "dy": rng.standard_normal(shape).astype(np.float32),
        "dmean": rng.standard_normal(c).astype(np.float32),
        "dvar": rng.standard_normal(c).astype(np.float32),
        "mean": rng.standard_normal(c).astype(np.float32),
        "var": (np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32),
    }


def _j(a, dt=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dt)


def _t(a, dt=torch.float32, grad=False):
    if a is None:
        return None
    return torch.from_numpy(a).to(dt).requires_grad_(grad)


def _close(a, b, dt, name):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), err_msg=name,
                               **_tol(dt))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_train_matches_jax(epi, dt):
    relu, has_res = EPILOGUES[epi]
    jdt, tdt = DTYPES[dt]
    d = _inputs(SHAPE, 0, has_res)

    def jf(x, s, b, r):
        return jops.fused_bn_train(x, s, b, residual=r, relu=relu)

    jin = (_j(d["x"], jdt), _j(d["scale"]), _j(d["bias"]),
           _j(d["res"], jdt))
    (jy, jm, jv), vjp = jax.vjp(jf, *jin)
    jgrads = vjp((_j(d["dy"], jdt), _j(d["dmean"]), _j(d["dvar"])))

    tin = [_t(d["x"], tdt, True), _t(d["scale"], grad=True),
           _t(d["bias"], grad=True), _t(d["res"], tdt, True)]
    ty, tm, tv = tops.fused_bn_train(tin[0], tin[1], tin[2],
                                     residual=tin[3], relu=relu)
    assert ty.dtype == tdt and tm.dtype == tv.dtype == torch.float32
    _close(jy, ty, dt, "y")
    _close(jm, tm, "f32", "mean")
    _close(jv, tv, "f32", "var")
    wrt = [t for t in tin if t is not None]
    tgrads = torch.autograd.grad(
        (ty, tm, tv), wrt,
        (_t(d["dy"], tdt), _t(d["dmean"]), _t(d["dvar"])))
    names = ("dx", "dscale", "dbias", "dres")
    for jg, tg, name in zip([g for g in jgrads if g is not None], tgrads,
                            names):
        _close(jg, tg, dt, name)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_apply_matches_jax(epi, dt):
    """Given-statistics (eval) variant with cotangents for every input,
    mean and var included."""
    relu, has_res = EPILOGUES[epi]
    jdt, tdt = DTYPES[dt]
    d = _inputs(SHAPE, 1, has_res)

    def jf(x, m, v, s, b, r):
        return jops.fused_bn_apply(x, m, v, s, b, residual=r, relu=relu)

    jin = (_j(d["x"], jdt), _j(d["mean"]), _j(d["var"]), _j(d["scale"]),
           _j(d["bias"]), _j(d["res"], jdt))
    jy, vjp = jax.vjp(jf, *jin)
    jgrads = vjp(_j(d["dy"], jdt))

    tin = [_t(d["x"], tdt, True), _t(d["mean"], grad=True),
           _t(d["var"], grad=True), _t(d["scale"], grad=True),
           _t(d["bias"], grad=True), _t(d["res"], tdt, True)]
    ty = tops.fused_bn_apply(*tin[:5], residual=tin[5], relu=relu)
    _close(jy, ty, dt, "y")
    wrt = [t for t in tin if t is not None]
    tgrads = torch.autograd.grad(ty, wrt, _t(d["dy"], tdt))
    names = ("dx", "dmean", "dvar", "dscale", "dbias", "dres")
    for jg, tg, name in zip([g for g in jgrads if g is not None], tgrads,
                            names):
        # dmean/dvar are f32 sums over rows on both sides
        _close(jg, tg, dt if name not in ("dmean", "dvar") else "f32",
               name)


@pytest.mark.parametrize("row_block", [16, 64])
def test_train_matches_jax_multiblock(row_block):
    """The JAX kernel's grid accumulation (several row blocks with a
    zero-padded tail) against the port on the same inputs."""
    d = _inputs((2, 9, 11, 40), 2, True)  # 198 rows
    jy, jm, jv = jfb.fused_bn_train(
        _j(d["x"]), _j(d["scale"]), _j(d["bias"]), residual=_j(d["res"]),
        relu=True, interpret=True, row_block=row_block)
    ty, tm, tv = tops.fused_bn_train(
        _t(d["x"]), _t(d["scale"]), _t(d["bias"]), residual=_t(d["res"]),
        relu=True)
    for a, b, name in ((jy, ty, "y"), (jm, tm, "mean"), (jv, tv, "var")):
        _close(a, b, "f32", name)


def test_large_mean_variance_is_centered():
    """A large-mean bf16 activation: the centered variance stays right
    where E[x^2] - mean^2 would cancel every bit."""
    rng = np.random.default_rng(3)
    x = (1000.0 + rng.standard_normal((4096, 8))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _, var = tfb.bn_stats(xt)
    x64 = xt.double()
    want = ((x64 - x64.mean(0)) ** 2).mean(0)
    np.testing.assert_allclose(var.numpy(), want.numpy(), rtol=1e-4)


def test_cpu_uses_plain_version_and_counts_nothing():
    tfb.reset_launch_counts()
    x = torch.randn(10, 8, requires_grad=True)
    y, _, _ = tops.fused_bn_train(x, torch.ones(8), torch.zeros(8),
                                  relu=True)
    y.sum().backward()
    assert x.grad is not None
    assert all(n == 0 for n in tfb.LAUNCHES.values())


def test_non_contiguous_rows_view_raises():
    x = torch.randn(4, 8, 6).transpose(1, 2)  # (4, 6, 8), not contiguous
    with pytest.raises((ValueError, RuntimeError)):
        tops.fused_bn_train(x, torch.ones(8), torch.zeros(8))


@pytest.mark.parametrize("rows,c", [(1, 64), (63, 64), (1568, 2048),
                                    (401408, 64), (25088, 512),
                                    (100000, 40)])
def test_reduction_chunks_cover_rows(rows, c):
    rpc, chunks = tfb.reduction_chunks(rows, c)
    assert 1 <= chunks <= 65535
    assert (chunks - 1) * rpc < rows <= chunks * rpc


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("rows,c", [(1, 64), (63, 64), (1568, 2048),
                                    (401408, 64), (100352, 256),
                                    (777, 100), (100000, 40)])
def test_stats_chunks_cover_rows(rows, c, esize):
    """``bn_stats`` chunks: every row in exactly one chunk, within the
    grid's limit, and no more blocks than one wave asks for (so its
    last-block merge reads few partials)."""
    rpc, chunks = tfb.stats_chunks(rows, c, esize)
    assert 1 <= chunks <= 65535
    assert (chunks - 1) * rpc < rows <= chunks * rpc
    assert chunks <= tfb._STATS_TARGET_BLOCKS


# ---------------------------------------------------------------------------
# bn_bwd_dx forms its per-channel coefficients itself (scale, rstd, S1, S2
# and the mean / var cotangents in, A, B, C inside the launch)
# ---------------------------------------------------------------------------


def _train_grads(x, scale, bias, res, relu, cts):
    """(dx, dscale, dbias[, dres]) of ``fused_bn_train`` under the
    cotangents ``cts`` of (y, mean, var); a None entry leaves that output
    out of the backward (detached)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, scale, bias, res) if t is not None]
    y, mean, var = tops.fused_bn_train(
        leaves[0], leaves[1], leaves[2],
        residual=leaves[3] if res is not None else None, relu=relu)
    outs, grads = zip(*[(o, g) for o, g in zip((y, mean, var), cts)
                        if g is not None])
    return torch.autograd.grad(outs, leaves, grads)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_detached_stats_equal_zero_cotangents(epi, dt):
    """Backward with mean / var left out (None cotangents: the dx launch
    skips their terms) equals the backward with explicit zero
    cotangents, bitwise: B - 0 * inv_m and C - 2 * 0 / (m * rstd) are B
    and C."""
    relu, has_res = EPILOGUES[epi]
    tdt = DTYPES[dt][1]
    d = _inputs(SHAPE, 4, has_res)
    x, res, dy = _t(d["x"], tdt), _t(d["res"], tdt), _t(d["dy"], tdt)
    scale, bias = _t(d["scale"]), _t(d["bias"])
    zero = torch.zeros(SHAPE[-1])
    detached = _train_grads(x, scale, bias, res, relu, (dy, None, None))
    zeros = _train_grads(x, scale, bias, res, relu, (dy, zero, zero))
    for a, b, name in zip(detached, zeros, ("dx", "dscale", "dbias",
                                            "dres")):
        assert torch.equal(a, b), name


def test_no_output_cotangent_gives_zero_dx():
    """Only the mean's cotangent flows back (dy is None): dx is
    dmean / m, the right result, and with all cotangents zero a zero dx
    and zero parameter gradients."""
    d = _inputs(SHAPE, 5, False)
    x, scale, bias = _t(d["x"]), _t(d["scale"]), _t(d["bias"])
    dmean = _t(d["dmean"])
    dx, dscale, dbias = _train_grads(x, scale, bias, None, False,
                                     (None, dmean, None))
    rows = x.numel() // SHAPE[-1]
    torch.testing.assert_close(dx, (dmean / rows).expand(SHAPE),
                               rtol=1e-6, atol=1e-7)
    assert not dscale.any() and not dbias.any()
    zero = torch.zeros(SHAPE[-1])
    dx, dscale, dbias = _train_grads(x, scale, bias, None, False,
                                     (None, zero, zero))
    assert not dx.any() and not dscale.any() and not dbias.any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_given_stats_dx_is_the_old_composition(epi, dt):
    """Given-stats mode (s1 = s2 = None) keeps the zero terms: bitwise
    ``a * dy_m - 0 - x_hat * 0``, so even the sign of a zero dx is the
    old composition's."""
    relu, has_res = EPILOGUES[epi]
    tdt = DTYPES[dt][1]
    d = _inputs(SHAPE, 6, has_res)
    x2 = _t(d["x"], tdt).view(-1, SHAPE[-1])
    dy2 = _t(d["dy"], tdt).view(-1, SHAPE[-1])
    mean, scale = _t(d["mean"]), _t(d["scale"])
    rstd = torch.rsqrt(_t(d["var"]) + 1e-5)
    a = scale * rstd
    y2 = tfb.bn_apply(x2, a, _t(d["bias"]) - mean * a, relu=relu)
    dx, dres = tfb.bn_bwd_dx(dy2, x2, y2, mean, rstd, scale, None, None,
                             None, None, 1.0 / x2.shape[0], relu, has_res)
    dym = tfb._masked_dy(dy2, y2, relu)
    xhat = (x2.float() - mean) * rstd
    zero = torch.zeros_like(a)
    assert torch.equal(dx, (a * dym - zero - xhat * zero).to(tdt))
    assert (dres is None) == (not has_res)
    if has_res:
        assert torch.equal(dres, dym.to(tdt))


def test_bn_bwd_dx_takes_both_sums_or_neither():
    x = torch.randn(6, 8)
    v = torch.ones(8)
    with pytest.raises(ValueError):
        tfb.bn_bwd_dx(x, x, x, v, v, v, v, None, None, None, 1 / 6, False)


@pytest.mark.parametrize("mode", ["train", "given_stats"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("epi", ["identity", "res_relu"])
@pytest.mark.parametrize("c", [64, 100])
def test_bn_bwd_dx_plain_matches_jax_vjp(c, epi, dt, mode):
    """``_bn_bwd_dx_plain`` with its coefficients formed from (scale,
    rstd, S1, S2, dmean, dvar, 1 / m) against dx (and dres) of JAX's
    ``fused_bn_train`` / ``fused_bn_apply`` VJP, at a C that is a
    multiple of the kernel's vector width (64) and one that is not
    (100), within the file's tolerances."""
    relu, has_res = EPILOGUES[epi]
    jdt, tdt = DTYPES[dt]
    shape = (2, 3, 5, c)
    d = _inputs(shape, 7, has_res)
    if mode == "train":
        def jf(x, r):
            return jops.fused_bn_train(x, _j(d["scale"]), _j(d["bias"]),
                                       residual=r, relu=relu)
        cts = (_j(d["dy"], jdt), _j(d["dmean"]), _j(d["dvar"]))
    else:
        def jf(x, r):
            return jops.fused_bn_apply(x, _j(d["mean"]), _j(d["var"]),
                                       _j(d["scale"]), _j(d["bias"]),
                                       residual=r, relu=relu)
        cts = _j(d["dy"], jdt)
    jx, jr = _j(d["x"], jdt), _j(d["res"], jdt)
    if has_res:
        _, vjp = jax.vjp(jf, jx, jr)
        jdx, jdres = vjp(cts)
    else:
        _, vjp = jax.vjp(lambda x: jf(x, None), jx)
        (jdx,), jdres = vjp(cts), None

    x2 = _t(d["x"], tdt).view(-1, c)
    dy2 = _t(d["dy"], tdt).view(-1, c)
    r2 = _t(d["res"], tdt).view(-1, c) if has_res else None
    scale, bias = _t(d["scale"]), _t(d["bias"])
    if mode == "train":
        mean, var = tfb.bn_stats(x2)
    else:
        mean, var = _t(d["mean"]), _t(d["var"])
    rstd = torch.rsqrt(var + 1e-5)
    a = rstd * scale
    y2 = tfb.bn_apply(x2, a, bias - mean * a, r2, relu)
    if mode == "train":
        s1, s2 = tfb.bn_bwd_sums(dy2, x2, y2, mean, rstd, relu)
        extra = (s1, s2, _t(d["dmean"]), _t(d["dvar"]))
    else:
        extra = (None,) * 4
    dx, dres = tfb.PLAIN["bn_bwd_dx"](dy2, x2, y2, mean, rstd, scale, *extra,
                                      1.0 / x2.shape[0], relu, has_res)
    _close(jnp.reshape(jdx, (-1, c)), dx, dt, "dx")
    if has_res:
        _close(jnp.reshape(jdres, (-1, c)), dres, dt, "dres")
