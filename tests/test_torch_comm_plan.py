"""The port's persisted communication plans (``distributed/comm_plan.py``)
and the launcher's ``--comm-plan`` / ``--mesh``, against the JAX
package's ``distributed/comm_plan.py``.

- The grammar (``flat | hier[:k] | auto | <path>``), save / load, the
  ``auto`` path and every fallback (missing, stale, malformed, another
  mesh, other DP axes: a ``CommPlanWarning`` and the flat schedule; an
  explicit ``hier:k`` out of range raises), as
  ``tests/test_hierarchical.py`` holds the JAX package's, and each
  resolution equal to the JAX package's on the same spec and files.
- A plan file written by the JAX package's ``save_plan`` loads in the
  port, and the reverse: the same JSON schema (``PLAN_VERSION`` 1).
- The launcher: ``hier_split`` outside the DP step raises; ``--comm-plan``
  without ``--dp-mode shardmap`` is refused; ``--comm-plan hier:1``
  without ``--mesh`` raises ``make_hierarchy``'s error (the default
  layout has one worker per node); ``--mesh 2x2`` without a
  hierarchical plan raises (the shard_map step is pure DP); a plan
  loaded from a file applies its wire configuration and is printed.
"""
import contextlib
import dataclasses
import io
import json
import warnings

import pytest

from repro.distributed import comm_plan as jcp
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import comm_plan as tcp
from repro_torch.distributed import shutdown
from repro_torch.launch import train as tlaunch

_RUN = dict(arch="resnet50", mesh_shape=(2, 4), dp_axes=("data", "model"))


def _plan(mod, **kw):
    base = dict(mesh_shape=(2, 4), dp_axes=("data", "model"),
                sync_mode="zero_overlap", wire="f16",
                bucket_bytes=4 << 20, hier_split=1, source="autotuner")
    base.update(kw)
    return mod.CommPlan(**base)


def _fields(plan):
    return None if plan is None else dataclasses.asdict(plan)


def test_schema_constants_match_jax():
    assert tcp.PLAN_VERSION == jcp.PLAN_VERSION
    assert tcp.SYNC_MODES == jcp.SYNC_MODES
    assert ([f.name for f in dataclasses.fields(tcp.CommPlan)]
            == [f.name for f in dataclasses.fields(jcp.CommPlan)])


@pytest.mark.parametrize("spec", ["flat", "hier", "hier:1", " hier:1 "])
def test_grammar_resolves_as_jax(spec):
    got = tcp.resolve_comm_plan(spec, **_RUN)
    assert _fields(got) == _fields(jcp.resolve_comm_plan(spec, **_RUN))
    if spec == "flat":
        assert got is None
    else:
        # a grammar form only reschedules: no wire-config override
        assert got.hier_split == 1 and got.bucket_bytes == 0
        assert got.describe() == "bucketed bf16 0KiB hier:1 on 2x4"


def test_hier_split_out_of_range_raises_as_jax():
    # the user named an exact schedule: no silent fallback
    with pytest.raises(ValueError, match="hier_split") as got:
        tcp.resolve_comm_plan("hier:2", **_RUN)
    with pytest.raises(ValueError) as want:
        jcp.resolve_comm_plan("hier:2", **_RUN)
    assert str(got.value) == str(want.value)


def test_save_load_roundtrip(tmp_path):
    plan = _plan(tcp)
    path = tcp.save_plan(plan, str(tmp_path / "p.json"))
    assert tcp.load_plan(path) == plan
    assert tcp.resolve_comm_plan(path, **_RUN) == plan
    assert plan.compression == "f16+bucketed"
    assert plan.describe() == _plan(jcp).describe()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plan_files_cross_between_the_packages(tmp_path, writer):
    """The same JSON: a plan written by either package's ``save_plan``
    loads in both, field for field, and the two files are the same
    bytes."""
    src, dst = (jcp, tcp) if writer == "jax" else (tcp, jcp)
    path = src.save_plan(_plan(src), str(tmp_path / "p.json"))
    got = dst.load_plan(path)
    assert _fields(got) == _fields(_plan(src))
    assert _fields(dst.resolve_comm_plan(path, **_RUN)) == _fields(got)
    other = dst.save_plan(got, str(tmp_path / "q.json"))
    assert open(other).read() == open(path).read()


def test_auto_finds_the_canonical_path(tmp_path):
    plan = _plan(jcp)
    assert (tcp.plan_path("resnet50", (2, 4), str(tmp_path))
            == jcp.plan_path("resnet50", (2, 4), str(tmp_path)))
    jcp.save_plan(plan, jcp.plan_path("resnet50", (2, 4), str(tmp_path)))
    got = tcp.resolve_comm_plan("auto", out_dir=str(tmp_path), **_RUN)
    assert _fields(got) == _fields(plan)
    assert got.compression == "f16+bucketed"


def _write(path, raw):
    path.write_text(json.dumps(raw))
    return str(path)


def _stale(tmp_path):
    raw = dataclasses.asdict(_plan(tcp))
    raw["version"] = tcp.PLAN_VERSION + 999
    return _write(tmp_path / "stale.json", raw)


FALLBACKS = {
    "missing": (lambda tmp: "auto", "no plan"),
    "stale": (_stale, "version"),
    "malformed": (lambda tmp: _write(
        tmp / "bad.json", {"version": tcp.PLAN_VERSION,
                           "sync_mode": "nope"}), "malformed"),
    # tuned on 4x2, this run is 2x4: the same worker count, another
    # layout, so the plan's split and buckets do not carry over
    "mesh": (lambda tmp: tcp.save_plan(_plan(tcp, mesh_shape=(4, 2)),
                                       str(tmp / "p.json")),
             "tuned for mesh"),
    "axes": (lambda tmp: tcp.save_plan(_plan(tcp, dp_axes=("x", "y")),
                                       str(tmp / "p.json")), "DP axes"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_fallbacks_warn_and_use_flat_as_jax(tmp_path, case):
    make, match = FALLBACKS[case]
    spec = make(tmp_path)
    with pytest.warns(tcp.CommPlanWarning, match=match) as got:
        assert tcp.resolve_comm_plan(spec, out_dir=str(tmp_path),
                                     **_RUN) is None
    with pytest.warns(jcp.CommPlanWarning) as want:
        assert jcp.resolve_comm_plan(spec, out_dir=str(tmp_path),
                                     **_RUN) is None
    if case != "missing":  # the hint names the tuner differently
        assert str(got[0].message) == str(want[0].message)


def test_stale_version_raises_on_load(tmp_path):
    path = _stale(tmp_path)
    with pytest.raises(tcp.StaleCommPlan, match="version"):
        tcp.load_plan(path)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_hier_split_rejected_outside_shardmap():
    with pytest.raises(ValueError, match="shard"):
        tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=8, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=5, dp_mode="none",
            hier_split=1, compression="bf16+bucketed", device="cpu")


def test_comm_plan_needs_the_data_parallel_step():
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--comm-plan", "hier:1", "--device",
                      "cpu"])


def test_hier_plan_without_a_mesh_raises_make_hierarchys_error():
    """The default layout puts every worker on "data" (one a node): the
    inner stage has one worker, and ``make_hierarchy`` refuses it."""
    with pytest.raises(ValueError, match="stages >= 2.*flat schedule"):
        tlaunch.main(["--reduced", "--dp-mode", "shardmap", "--compression",
                      "bf16+bucketed", "--comm-plan", "hier:1", "--steps",
                      "1", "--global-batch", "8", "--device", "cpu"])


@pytest.mark.parametrize("plan", ["flat", "none"])
def test_mesh_without_a_hierarchical_plan_raises(plan):
    argv = ["--reduced", "--dp-mode", "shardmap", "--compression",
            "bf16+bucketed", "--mesh", "2x2", "--steps", "1",
            "--global-batch", "8", "--device", "cpu"]
    if plan == "flat":
        argv += ["--comm-plan", "flat"]
    with pytest.raises(NotImplementedError, match="item 15.6"):
        tlaunch.main(argv)


def test_mesh_must_lay_out_every_worker():
    try:
        with pytest.raises(ValueError, match="lays out 4 workers"):
            tlaunch.build_train_setup(
                treduced(tget("resnet50")), global_batch=8, seq_len=0,
                opt_cfg=TOpt(), steps_per_epoch=5, dp_mode="shardmap",
                compression="bf16+bucketed", dp_axes=tlaunch.MESH_AXES,
                hier_split=1, mesh_shape=(2, 2), device="cpu")
    finally:
        shutdown()


def test_a_loaded_plan_applies_its_wire_config(tmp_path):
    """One worker (a 1x1 layout): a flat plan file naming the overlapped
    sync, the f16 wire and 1 MiB buckets is applied and printed."""
    path = tcp.save_plan(tcp.CommPlan(
        mesh_shape=(1, 1), dp_axes=("data", "model"), sync_mode="overlap",
        wire="f16", bucket_bytes=1 << 20, hier_split=None),
        str(tmp_path / "p.json"))
    buf = io.StringIO()
    with warnings.catch_warnings():
        warnings.simplefilter("error", tcp.CommPlanWarning)
        with contextlib.redirect_stdout(buf):
            res = tlaunch.main(["--reduced", "--dp-mode", "shardmap",
                                "--comm-plan", path, "--steps", "2",
                                "--global-batch", "8", "--device", "cpu"])
    assert "comm plan: overlap f16 1024KiB flat on 1x1" in buf.getvalue()
    assert len(res.history) == 2
