"""The rmsnorm kernel's launch plan (``kernels/rmsnorm.py``
``row_layout`` / ``launch_plan``), which runs on the CPU: every RMSNorm
width of the port's registry gets a held instance whose loads cover the
row exactly, the layout (and so the row sum's order) is the same at
every row count, the grid is persistent, and only a launch whose x
outgrows L2 takes the evict-first hint. No JAX and no card: the
plan is plain Python, and the kernel itself is held to its plain version
on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.mamba import mamba2_dims
from repro_torch.models.xlstm import _mlstm_dims

DTYPES = (torch.bfloat16, torch.float32)
N_SMS, L2 = 132, 50 * 2 ** 20  # an H100 SXM
# prefill (8 x 1,024; phi-3-vision's 8 x 1,600 with patches; mixtral's
# 4 x 4,064 x 2), decode (8), training (4 x 1,024) rows, and odd counts
ROWS = (8192, 12800, 32512, 8, 4096, 1, 333, 5)


def rmsnorm_widths():
    """Every width an RMSNorm of the registry normalizes: the d_model of
    each config whose norm is RMSNorm, and the Mamba2 and mLSTM
    ``out_norm`` width d_in (an RMSNorm whatever the config's norm)."""
    widths = {}
    for arch in sorted(_REGISTRY):
        cfg = get_config(arch)
        if cfg.family == "conv":
            continue
        if cfg.norm == "rmsnorm":
            widths.setdefault(cfg.d_model, []).append(arch)
        if cfg.family == "hybrid":
            widths.setdefault(mamba2_dims(cfg)[0], []).append(arch + " d_in")
        if cfg.family == "ssm":
            widths.setdefault(_mlstm_dims(cfg)[0], []).append(arch + " d_in")
    return widths


def test_registry_widths_are_the_port_widths():
    assert sorted(rmsnorm_widths()) == [2048, 3072, 3584, 4096, 5120, 7168,
                                        8192]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", sorted(rmsnorm_widths()))
def test_every_registry_width_has_a_held_instance(d, dtype):
    lay = rn.row_layout(d, dtype)
    vec = 16 // dtype.itemsize
    assert lay.held in rn.HELD_LOADS
    assert lay.held == lay.loads
    assert lay.loads * 32 * lay.warps * vec == d  # covers d exactly
    assert 1 <= lay.warps <= rn.MAX_WARPS
    assert lay.loads <= rn.MAX_LOADS
    # one warp a row: several rows a block; several warps: one row
    assert lay.rows_per_block == (rn.WARP_ROWS if lay.warps == 1 else 1)
    assert 32 * lay.warps * lay.rows_per_block <= 32 * rn.MAX_WARPS


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", sorted(rmsnorm_widths()) + [128, 100, 384,
                                                          1024, 6144])
def test_layout_is_the_same_at_every_row_count(d, dtype):
    """The threads a row lies on, and so its sum's order, depend on d and
    the dtype alone: prefill, decode, training and odd row counts, and
    any residency, get one layout."""
    layouts = {rn.launch_plan(rows, d, dtype, N_SMS, resident, L2)[:4]
               for rows in ROWS for resident in (1, 3, 8)}
    assert layouts == {tuple(rn.row_layout(d, dtype))}


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", sorted(rmsnorm_widths()) + [128, 100])
@pytest.mark.parametrize("rows", ROWS)
def test_grid_is_persistent(rows, d, dtype):
    for resident in (1, 4, 16):
        plan = rn.launch_plan(rows, d, dtype, N_SMS, resident, L2)
        groups = -(-rows // plan.rows_per_block)
        assert 1 <= plan.grid <= groups
        assert plan.grid <= N_SMS * resident
        assert plan.grid == min(groups, N_SMS * resident)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [100, 5, 128, 1, 3000])
def test_odd_widths_take_the_generic_instance(d, dtype):
    """A d the held instances do not cover exactly (the reduced configs'
    d 128 in bf16, d 100 of the ``(5, 100)`` case) takes the generic
    instance, whose loads still cover the row."""
    plan = rn.launch_plan(5, d, dtype, N_SMS, 8, L2)
    vec = 16 // dtype.itemsize
    if d == 128 and dtype == torch.float32:
        # covered exactly by one load a thread, a class with no instance
        assert plan.loads * 32 * plan.warps * vec == d
    assert plan.held == 0
    assert plan.loads * 32 * plan.warps * vec >= d
    assert (plan.loads - 1) * 32 * plan.warps * vec < d
    assert plan.grid == min(-(-5 // plan.rows_per_block), N_SMS * 8)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("d", sorted(rmsnorm_widths()))
def test_misaligned_takes_the_generic_instance_in_the_same_layout(d, dtype):
    """A pointer that is not 16-byte aligned takes the generic instance
    with the held one's warps and loads: the same sum order, so the same
    bits."""
    held = rn.launch_plan(8, d, dtype, N_SMS, 8, L2)
    moved = rn.launch_plan(8, d, dtype, N_SMS, 8, L2, aligned=False)
    assert moved.held == 0
    assert moved[1:] == held[1:]
    big = rn.launch_plan(32512, d, dtype, N_SMS, 8, L2, aligned=False)
    assert not big.evict  # the generic instance takes no hint


@pytest.mark.parametrize("rows,d,dtype,evict", [
    (8192, 2048, torch.bfloat16, False),    # 32 MiB of x stays in L2
    (4096, 4096, torch.bfloat16, False),    # training rows
    (8, 8192, torch.bfloat16, False),       # a decode step
    (12800, 3072, torch.bfloat16, True),    # phi-3-vision's prefill
    (8192, 3584, torch.bfloat16, True),
    (8192, 8192, torch.bfloat16, True),
    (32512, 4096, torch.bfloat16, True),
    (8192, 2048, torch.float32, True),
    (12800, 100, torch.float32, False),     # generic: no hint
])
def test_evict_first_only_past_l2(rows, d, dtype, evict):
    """x larger than L2 is read, and y written, with the evict-first
    hint; the layout is the same either way."""
    plan = rn.launch_plan(rows, d, dtype, N_SMS, 4, L2)
    assert plan.evict is evict
    assert plan[:4] == tuple(rn.row_layout(d, dtype))


def test_plan_refuses_empty_launches():
    for args in ((0, 2048, torch.bfloat16, N_SMS, 8, L2),
                 (8, 2048, torch.bfloat16, 0, 8, L2),
                 (8, 2048, torch.bfloat16, N_SMS, 0, L2)):
        with pytest.raises(ValueError):
            rn.launch_plan(*args)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    """On the CPU the wrapper takes the plain version; the plan is never
    read there, and nothing is launched."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 100, generator=g).bfloat16()
    scale = torch.randn(100, generator=g).bfloat16()
    rn.reset_launch_counts()
    got = rn.rmsnorm(x, scale, round_inv=True)
    assert torch.equal(got, rn.PLAIN["rmsnorm"](x, scale, 1e-5, True))
    assert rn.LAUNCHES == {"rmsnorm": 0}
