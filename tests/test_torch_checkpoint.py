"""The port's checkpointer (``repro_torch.checkpoint``) and the whole train
state in the JAX package's checkpoint layout (``interop.train_state_to_jax``
/ ``train_state_from_jax``), against the JAX package's checkpointer.

1. The JAX package's checkpoint tests (``tests/test_checkpoint.py`` and the
   checkpoint tests of ``tests/test_resilience.py``), run against the port:
   round trip, corrupt newest skipped, torn or bit-flipped payload falls
   back, explicit step raises, crc mismatch, atomic re-save, stale temp
   directories, one host snapshot per save, the best checkpoint.
2. Cross-package, on the reduced ResNet after 2 steps, for the per-leaf
   ``rmsprop_warmup`` state, the stream-LARS state at one worker, and the
   shard_map DP state on 2 virtual devices against 2 gloo workers
   (bf16+bucketed, error feedback): a JAX checkpoint restores in the port
   bitwise equal to the ``interop`` conversion of the JAX state, a port
   checkpoint restores in JAX (``restore(target=jax_state)``) bitwise
   equal to it, and both packages' files of the same state have the same
   keys, dtypes and crc32s. Under overlap_comm, where the two packages
   lay the stream-LARS ``delta`` out in different orders, the port's
   ``delta`` after two steps is the JAX package's leaf by leaf, and
   files cross both ways.
3. Resume: 3 steps, then a fresh setup resumes from the step-3 checkpoint
   for 3 more, bitwise equal to 6 unbroken steps (single-device step, DP
   step on one gloo worker with error feedback, stream-LARS). JAX resumes
   from the port's step-3 checkpoint and runs steps 4-6 within the DP
   tolerances of ROADMAP queue 3 (losses rtol 2e-5, parameters within a
   relative norm of 2e-4) of the port's unbroken run.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.checkpoint import checkpointer as jck
from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.distributed.bucketing import (
    plan_ready_buckets as jplan_ready_buckets)
from repro.launch.train import build_train_setup as jsetup
from repro.training import LoopConfig as JLoopConfig
from repro.training import run_training as jrun_training
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.checkpoint.checkpointer import (
    ARRAYS,
    MANIFEST,
    AsyncCheckpointer,
    CheckpointCorruptError,
    gc_stale_tmpdirs,
    list_checkpoints,
    restore,
    restore_best,
    save,
    save_best,
)
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch
from repro_torch.training import LoopConfig, run_training

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SPE = 8, 4
LARS = dict(kind="lars", schedule="poly", warmup_epochs=1.0, total_epochs=2.0)


def _tree(v=0.0, seed=0):
    """A small train-state-like tree of tensors from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
        rng.standard_normal((8, 4), np.float32) + np.float32(v)),
        "b": torch.full((4,), float(v))},
        "opt": {"step": torch.tensor(int(v), dtype=torch.int32),
                "delta": {"w": torch.from_numpy(
                    rng.standard_normal((8, 4), np.float32)),
                    "b": torch.zeros(4)}}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


# ---------------------------------------------------------------------------
# 1. the JAX package's checkpoint tests, against the port
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    state = _tree(1.0)
    save(str(tmp_path), 7, state, metadata={"arch": "x"})
    got, manifest = restore(str(tmp_path), target=_zeros_like(state))
    assert manifest["step"] == 7 and manifest["metadata"]["arch"] == "x"
    _assert_trees_equal(got, state)
    assert got["opt"]["step"].dtype == torch.int32


def test_keys_are_jax_keystr_in_flatten_order(tmp_path):
    """The port writes ``jax.tree_util.keystr`` keys, and the npz members
    in the order the JAX package writes them."""
    state = {"b": {"z": np.ones(2, np.float32), "a/x": np.zeros(1)},
             "a": np.int32(3)}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(state)[0]]
    path = save(str(tmp_path), 1, state)
    with np.load(os.path.join(path, ARRAYS)) as z:
        assert z.files == want


def test_corrupt_checkpoint_skipped(tmp_path):
    state = _tree(1.0)
    save(str(tmp_path), 1, state)
    save(str(tmp_path), 2, state)
    with open(tmp_path / "step_0000000002" / MANIFEST, "w") as f:
        f.write("{truncated")  # a crash mid-save
    assert list_checkpoints(str(tmp_path)) == [1]
    _, manifest = restore(str(tmp_path), target=state)
    assert manifest["step"] == 1


def test_restore_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), target={"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing"):
        restore(str(tmp_path), target={"v": torch.zeros(4)})


def test_async_checkpointer_gc_and_wait(tmp_path):
    ac = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        ac.save(step, _tree(1.0))
    ac.wait()
    assert list_checkpoints(str(tmp_path)) == [20, 30]


def test_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    def failing_write(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write_checkpoint", failing_write)
    ac = AsyncCheckpointer(str(tmp_path))
    ac.save(1, _tree(1.0))
    with pytest.raises(OSError, match="disk full"):
        ac.wait()
    ac.wait()  # reported once


def test_save_best_single_retained(tmp_path):
    state = _tree(1.0)
    save_best(str(tmp_path), 5, state, metadata={"top1": 0.4})
    save_best(str(tmp_path), 9, _tree(2.0), metadata={"top1": 0.7})
    got, manifest = restore_best(str(tmp_path), target=state)
    assert manifest["step"] == 9 and manifest["metadata"]["top1"] == 0.7
    _assert_trees_equal(got, _tree(2.0))
    assert list_checkpoints(str(tmp_path / "best")) == [9]
    # best lives outside the rotating window: untouched by main-dir GC
    ac = AsyncCheckpointer(str(tmp_path), keep=1)
    for step in (10, 20):
        ac.save(step, state)
    ac.wait()
    assert list_checkpoints(str(tmp_path)) == [20]
    assert list_checkpoints(str(tmp_path / "best")) == [9]


def test_async_snapshot_isolated_from_in_place_update(tmp_path):
    """The port's analogue of the JAX package's donation test: the step
    updates its tensors in place right after ``save`` returns; the
    checkpoint holds the values at the call."""
    ac = AsyncCheckpointer(str(tmp_path), keep=1)
    w = torch.ones(4)
    ac.save(1, {"w": w})
    w.mul_(0.0)  # the next step's in-place update
    ac.wait()
    got, _ = restore(str(tmp_path), target={"w": w})
    assert torch.equal(got["w"], torch.ones(4))


def test_list_checkpoints_requires_payload(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    os.makedirs(os.path.join(d, "step_0000000002"))
    with open(os.path.join(d, "step_0000000002", MANIFEST), "w") as f:
        json.dump({"step": 2, "keys": []}, f)  # manifest, no arrays.npz
    assert list_checkpoints(d) == [1]


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_restore_falls_back_on_damaged_newest(tmp_path, damage):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    payload = os.path.join(d, "step_0000000002", ARRAYS)
    if damage == "truncate":
        with open(payload, "r+b") as f:
            f.truncate(os.path.getsize(payload) // 2)
    else:  # one flipped byte inside the stored array bytes
        needle = _tree(2.0)["params"]["w"].numpy().tobytes()
        blob = open(payload, "rb").read()
        pos = blob.find(needle)
        assert pos > 0, "stored array bytes not found in npz"
        with open(payload, "r+b") as f:
            f.seek(pos + 2)
            byte = f.read(1)
            f.seek(pos + 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    seen = []
    arrays, manifest = restore(d, on_corrupt=lambda s, e: seen.append(s))
    assert manifest["step"] == 1 and seen == [2]
    np.testing.assert_array_equal(arrays["['params']['w']"],
                                  _tree(1.0)["params"]["w"].numpy())


def test_restore_explicit_step_still_raises_on_corrupt(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    with open(os.path.join(d, "step_0000000002", ARRAYS), "r+b") as f:
        f.truncate(10)
    with pytest.raises(CheckpointCorruptError):
        restore(d, step=2)
    _, manifest = restore(d, step=1)
    assert manifest["step"] == 1


def test_restore_crc_mismatch_detected(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    payload = os.path.join(d, "step_0000000002", ARRAYS)
    with np.load(payload) as z:
        arrays = {k: z[k] for k in z.files}
    key = "['params']['w']"
    arrays[key] = arrays[key] + 1.0
    np.savez(payload, **arrays)  # a valid zip with changed bytes
    _, manifest = restore(d)
    assert manifest["step"] == 1
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        restore(d, step=2)


def test_restore_raises_when_every_candidate_corrupt(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    with open(os.path.join(d, "step_0000000001", ARRAYS), "r+b") as f:
        f.truncate(4)
    with pytest.raises(CheckpointCorruptError, match="every candidate"):
        restore(d)


@pytest.mark.parametrize("fail_at", ["rename", "savez"])
def test_failed_resave_keeps_old(tmp_path, monkeypatch, fail_at):
    """A crash in the replace window (the rename) or before it (the
    payload write) leaves the old checkpoint in place and no litter."""
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    if fail_at == "rename":
        real_rename = os.rename

        def failing(src, dst):
            if os.path.basename(src).startswith(".tmp_ckpt_"):
                raise OSError("simulated crash")
            return real_rename(src, dst)

        monkeypatch.setattr(ck.os, "rename", failing)
    else:
        def failing(*a, **kw):
            raise OSError("simulated crash")

        monkeypatch.setattr(ck.np, "savez", failing)
    with pytest.raises(OSError, match="simulated"):
        save(d, 1, _tree(99.0))
    monkeypatch.undo()
    arrays, manifest = restore(d)
    assert manifest["step"] == 1
    np.testing.assert_array_equal(arrays["['params']['w']"],
                                  _tree(1.0)["params"]["w"].numpy())
    assert gc_stale_tmpdirs(d) == 0


def test_async_checkpointer_gcs_stale_tmpdirs(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_ckpt_dead"))
    os.makedirs(os.path.join(d, ".old_ckpt_dead"))
    save(d, 1, _tree(1.0))
    AsyncCheckpointer(d)
    names = set(os.listdir(d))
    assert not {".tmp_ckpt_dead", ".old_ckpt_dead"} & names
    assert "step_0000000001" in names


def test_async_save_snapshots_host_arrays_exactly_once(tmp_path,
                                                       monkeypatch):
    calls = []
    real_flatten = ck._flatten

    def counting_flatten(tree):
        calls.append(1)
        return real_flatten(tree)

    monkeypatch.setattr(ck, "_flatten", counting_flatten)
    AsyncCheckpointer(str(tmp_path)).save(3, _tree(3.0), block=True)
    assert len(calls) == 1, "async save must not re-copy on the worker"
    assert restore(str(tmp_path))[1]["step"] == 3


def test_manifest_carries_crc32_per_array(tmp_path):
    path = save(str(tmp_path), 1, _tree(1.0))
    manifest = json.load(open(os.path.join(path, MANIFEST)))
    assert set(manifest["crc32"]) == set(manifest["keys"])
    assert all(isinstance(v, int) for v in manifest["crc32"].values())


def test_bf16_leaf_written_as_the_jax_package_writes_it(tmp_path):
    """numpy has no bfloat16: both packages store a bf16 leaf as raw
    2-byte elements (``|V2``), with the same bytes, dtype and crc32, and
    the port reads the JAX package's file back bitwise. (The JAX
    package's own ``restore`` cannot cast ``|V2`` back to bfloat16, for
    its own files as for the port's.)"""
    vals = np.random.default_rng(0).standard_normal(13).astype(np.float32)
    jtree = {"m": jnp.asarray(vals, jnp.bfloat16)}
    ttree = {"m": torch.from_numpy(vals).bfloat16()}
    jpath = jck.save(str(tmp_path / "jax"), 1, jtree)
    tpath = save(str(tmp_path / "port"), 1, ttree)
    jm, tm = (json.load(open(os.path.join(p, MANIFEST)))
              for p in (jpath, tpath))
    assert jm["crc32"] == tm["crc32"]
    with np.load(os.path.join(jpath, ARRAYS)) as a, \
            np.load(os.path.join(tpath, ARRAYS)) as b:
        assert a["['m']"].dtype == b["['m']"].dtype
        assert a["['m']"].tobytes() == b["['m']"].tobytes()
    got, _ = restore(str(tmp_path / "jax"), target=ttree)
    assert torch.equal(got["m"], ttree["m"])
    with pytest.raises(ValueError, match="cast"):
        jck.restore(str(tmp_path / "jax"), target=jtree)


# ---------------------------------------------------------------------------
# 2. cross-package checkpoints of the reduced ResNet after 2 steps
# ---------------------------------------------------------------------------


def _file_facts(directory, step):
    """{key: (dtype, crc32)} of one checkpoint."""
    path = os.path.join(directory, f"step_{step:010d}")
    manifest = json.load(open(os.path.join(path, MANIFEST)))
    with np.load(os.path.join(path, ARRAYS)) as z:
        return {k: (str(z[k].dtype), manifest["crc32"][k]) for k in z.files}


def _nest(flat):
    """A checkpoint's ``{keystr: array}`` as the nested tree it came from."""
    tree = {}
    for key, v in flat.items():
        parts = interop._KEY.findall(key)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _port_flat(state, shardings=None):
    return ck._flatten(interop.train_state_to_jax(state, shardings))


def _assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's single-device step (per-leaf rmsprop_warmup,
    fused BN), compiled once for the module: (host copy of the initial
    state, step, data); the step donates, so each use starts from the
    host copy."""
    _, js, jstep, jdata, _, _ = jsetup(
        jreduced(jget("resnet50")), global_batch=BATCH, seq_len=0,
        opt_cfg=JOpt(), steps_per_epoch=SPE, fused_bn=True)
    return jax.tree.map(np.array, js), jstep, jdata


@pytest.mark.parametrize("layout", ["per_leaf", "stream_lars"])
def test_checkpoints_cross_between_packages(tmp_path, request, layout):
    jc, tc = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=SPE)
    if layout == "stream_lars":
        init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1)
        kw.update(dp_mode="shardmap", compression="bf16+bucketed")
        topt = TOpt(**LARS)
        _, js, jstep, jdata, jput, _ = jsetup(
            jc, opt_cfg=JOpt(**LARS),
            mesh=jax.make_mesh((1, 1), ("data", "model")), **kw)
    else:
        topt, jput = TOpt(), None
        host0, jstep, jdata = request.getfixturevalue("jax_single")
        js = jax.tree.map(jnp.asarray, host0)
    try:
        for i in range(2):
            batch = jdata.batch_at(i)
            js, _ = jstep(js, jput(batch) if jput else batch)
        jck.save(str(tmp_path / "jax"), 2, js, metadata={"from": "jax"})
        fresh = [tlaunch.build_train_setup(tc, opt_cfg=topt, device="cpu",
                                           **kw) for _ in range(2)]
        shardings = fresh[0][5]
        assert (shardings is None) == (layout == "per_leaf")
        if layout == "stream_lars":
            assert torch.is_tensor(fresh[0][1]["opt"]["delta"])
        # JAX save -> port restore == the interop conversion, bitwise
        arrays, manifest = restore(str(tmp_path / "jax"))
        from_file = interop.train_state_from_jax(arrays, fresh[0][1],
                                                 shardings)
        converted = interop.train_state_from_jax(
            jax.tree.map(np.asarray, js), fresh[1][1], shardings)
        assert from_file["opt"]["step"] == converted["opt"]["step"] == 2
        _assert_flat_equal(_port_flat(from_file, shardings),
                           _port_flat(converted, shardings))
        # port save -> JAX restore(target=jax_state) == the JAX state
        save(str(tmp_path / "port"), 2,
             interop.train_state_to_jax(from_file, shardings),
             metadata=manifest["metadata"])
        got, jmanifest = jck.restore(str(tmp_path / "port"), target=js)
        assert jmanifest["metadata"] == {"from": "jax"}
        want = jax.tree_util.tree_flatten_with_path(js)[0]
        for (path, a), b in zip(want, jax.tree.leaves(got)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
                jax.tree_util.keystr(path)
            assert np.asarray(a).dtype == np.asarray(b).dtype
        # the same state: the same keys, dtypes and crc32s in both files
        assert _file_facts(tmp_path / "jax", 2) == \
            _file_facts(tmp_path / "port", 2)
    finally:
        shutdown()


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_ready_leaves(model, params, model_state, bucket_bytes):
    """The JAX package's overlapped stream layout of ``params``, from its
    own staged loss and ready plan: ``[(name, slot)]`` in stream order
    (names joined with "/" as the port's)."""
    dummy = {"images": jnp.zeros((BATCH, 32, 32, 3)),
             "labels": jnp.zeros((BATCH,), jnp.int32)}
    staged = model.loss_segments(
        params, jax.tree.map(lambda x: x[0], model_state), dummy, 0.0)
    stages = list(reversed(staged.seg_params))
    plan = jplan_ready_buckets(stages, bucket_bytes, "bf16").base
    names = ["/".join((seg,) + tuple(str(k.key) for k in path))
             for seg, t in zip(reversed(staged.names), stages)
             for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    return list(zip(names, plan.slots))


def test_overlap_stream_lars_checkpoint_crosses_packages(tmp_path):
    """Under overlap_comm the JAX package keeps the stream-LARS ``delta``
    in ready order and the port in leaf order. After the same two steps
    from the same state, the port's ``delta`` written in the JAX layout
    is the JAX package's own, leaf by leaf (each cut by the JAX
    package's ready plan); a JAX file restores in the port bitwise leaf
    by leaf; the port's save of it restores in JAX bitwise.

    The per-leaf tolerance is the one the JAX package holds its own
    bucketed / overlapped stream-LARS pair to (``tests/test_lars_stream.py``
    ``assert_state``: rtol 1e-2, atol 1e-4, elementwise), since that is
    the difference here: the port's overlapped update is its bucketed
    one. The whole stream is also held to the DP tolerance of ROADMAP
    queue 3 (relative norm 2e-4), and a control shows that the
    comparison sees a ``delta`` written in the wrong order."""
    bucket = 8192
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=SPE,
              dp_mode="shardmap", compression="bf16+bucketed",
              bucket_bytes=bucket, overlap_comm=True, fused_bn=True)
    try:
        jmodel, js, jstep, jdata, jput, _ = jsetup(
            jreduced(jget("resnet50")), opt_cfg=JOpt(**LARS),
            mesh=jax.make_mesh((1, 1), ("data", "model")), **kw)
        js0 = jax.tree.map(np.array, js)
        fresh = [tlaunch.build_train_setup(
            treduced(tget("resnet50")), opt_cfg=TOpt(**LARS), device="cpu",
            **kw) for _ in range(2)]
        _, ts, tstep, _, tput, sh = fresh[0]
        leaves = _jax_ready_leaves(jmodel, js["params"],
                                   js["model_state"], bucket)
        assert list(sh.stream_order) == [k for k, _ in leaves]
        interop.train_state_from_jax(js0, ts, sh)
        for i in range(2):
            batch = jdata.batch_at(i)
            js, _ = jstep(js, jput(batch))
            ts, _ = tstep(ts, tput(batch))
        jdelta = np.asarray(js["opt"]["delta"])
        tdelta = interop.train_state_to_jax(ts, sh)["opt"]["delta"]
        for name, sl in leaves:
            np.testing.assert_allclose(tdelta[sl.offset:sl.offset + sl.size],
                                       jdelta[sl.offset:sl.offset + sl.size],
                                       rtol=1e-2, atol=1e-4, err_msg=name)
        end = leaves[-1][1].offset + leaves[-1][1].size
        assert not tdelta[end:].any() and not jdelta[end:].any()
        assert _rel(tdelta, jdelta) < 2e-4
        # the control: the same delta written in leaf order is not it
        assert _rel(interop.stream_opt_state_to_jax(
            ts["opt"], ts["params"])["delta"], jdelta) > 0.5
        # JAX file -> port: the leaf-order delta, bitwise leaf by leaf
        jck.save(str(tmp_path / "jax"), 2, js, metadata={"from": "jax"})
        arrays, manifest = restore(str(tmp_path / "jax"))
        target = fresh[1][1]
        interop.train_state_from_jax(arrays, target, sh)
        got = target["opt"]["delta"]
        off = 0
        for name in tb.leaf_order(target["params"]):
            shape = tuple(target["params"][name].shape)
            size = int(np.prod(shape))
            sl = dict(leaves)[name]
            want = jdelta[sl.offset:sl.offset + sl.size].reshape(sl.shape)
            if want.ndim == 4:  # HWIO -> OIHW
                want = want.transpose(3, 2, 0, 1)
            assert np.array_equal(got[off:off + size].numpy().reshape(shape),
                                  want), name
            off += size
        # port save -> JAX restore: the JAX state, bitwise
        save(str(tmp_path / "port"), 2,
             interop.train_state_to_jax(target, sh),
             metadata=manifest["metadata"])
        back, _ = jck.restore(str(tmp_path / "port"), target=js)
        assert np.asarray(back["opt"]["delta"]).tobytes() == \
            jdelta.tobytes()
    finally:
        shutdown()


_JAX_TWO_DEVICES = """
    import jax
    from repro.checkpoint import save
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.launch.train import build_train_setup
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    _, s, step, data, put, _ = build_train_setup(
        cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
        steps_per_epoch={spe}, mesh=mesh, dp_mode="shardmap",
        compression="bf16+bucketed", error_feedback=True)
    for i in range(2):
        s, _ = step(s, put(data.batch_at(i)))
    save("{out}/jax", 2, s, metadata={{"from": "jax"}})
"""


def _two_worker_resave(rank, out_dir):
    """A gloo worker: restore the JAX file (this worker's row of the BN
    state and EF residual), then save it back through the gather of the
    per-worker entries; rank 0 writes."""
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=2)
    try:
        _, state, _, _, _, shardings = tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=16, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=SPE, dp_mode="shardmap",
            compression="bf16+bucketed", error_feedback=True, device="cpu")
        arrays, manifest = restore(os.path.join(out_dir, "jax"))
        interop.train_state_from_jax(arrays, state, shardings)
        rows = {"ef": state["ef_residual"]["fc/w"].numpy(),
                "mean": state["model_state"]["stem/bn"]["mean"].numpy()}
        np.savez(os.path.join(out_dir, f"rows_{rank}.npz"), **rows)
        tree = interop.train_state_to_jax(state, shardings)
        assert (tree is None) == (rank != 0)
        if rank == 0:
            save(os.path.join(out_dir, "port"), manifest["step"], tree,
                 metadata=manifest["metadata"])
    finally:
        shutdown()


def test_dp_checkpoint_crosses_two_devices_and_two_workers(tmp_path):
    """shard_map DP on 2 virtual devices (bf16+bucketed, error feedback)
    against 2 gloo workers: each worker restores its own row of the JAX
    file, and their save (the per-worker entries gathered to rank 0) is
    the JAX file's state with the same keys, dtypes and crc32s; JAX
    restores it bitwise."""
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_TWO_DEVICES.format(spe=SPE, out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    mp.spawn(_two_worker_resave, args=(str(tmp_path),), nprocs=2)
    jarrays, _ = jck.restore(str(tmp_path / "jax"))
    for r in (0, 1):
        rows = np.load(tmp_path / f"rows_{r}.npz")
        np.testing.assert_array_equal(
            rows["ef"], jarrays["['ef_residual']['fc']['w']"][r])
        np.testing.assert_array_equal(
            rows["mean"], jarrays["['model_state']['stem/bn']['mean']"][r])
    facts = _file_facts(tmp_path / "port", 2)
    assert facts == _file_facts(tmp_path / "jax", 2)
    assert any(k.startswith("['ef_residual']") for k in facts)
    got, _ = jck.restore(str(tmp_path / "port"), target=_nest(jarrays))
    for k, v in jck._flatten(got).items():
        assert v.tobytes() == jarrays[k].tobytes(), k


# ---------------------------------------------------------------------------
# 3. resume
# ---------------------------------------------------------------------------

RESUME = {
    "single": dict(opt_cfg=TOpt()),
    "dp_ef": dict(opt_cfg=TOpt(), dp_mode="shardmap",
                  compression="bf16+bucketed", error_feedback=True),
    "stream_lars": dict(opt_cfg=TOpt(**LARS), dp_mode="shardmap",
                        compression="bf16+bucketed"),
}


def _port_run(tmp_path, kind, total, ckpt_dir=None, every=3):
    setup = tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=BATCH, seq_len=0,
        steps_per_epoch=SPE, fused_bn=True, device="cpu", **RESUME[kind])
    _, state, step, data, put, shardings = setup
    return run_training(step, state, data,
                        LoopConfig(total_steps=total, checkpoint_every=every,
                                   checkpoint_dir=ckpt_dir, log_every=1),
                        put_batch=put, state_shardings=shardings), shardings


@pytest.mark.parametrize("kind", list(RESUME))
def test_resume_is_bitwise_the_unbroken_run(tmp_path, kind):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        ckdir = str(tmp_path / "ck")
        ref, sh = _port_run(tmp_path, kind, 6)
        first, _ = _port_run(tmp_path, kind, 3, ckdir)
        assert list_checkpoints(ckdir) == [3]
        res, _ = _port_run(tmp_path, kind, 6, ckdir, every=100)
        assert first.resumed_from is None and res.resumed_from == 3
        assert [h["loss"] for h in res.history] == \
            [h["loss"] for h in ref.history[3:]]
        _assert_flat_equal(_port_flat(res.state, sh),
                           _port_flat(ref.state, sh))
        if kind == "dp_ef":
            assert "ef_residual" in res.state
        assert list_checkpoints(ckdir) == [3, 6]
    finally:
        shutdown()


def _rel_norm(a, b) -> float:
    num = sum(float(np.square(np.float64(a[k]) - np.float64(b[k])).sum())
              for k in b)
    return (num / sum(float(np.square(np.float64(v)).sum())
                      for v in b.values())) ** 0.5


def test_jax_resumes_from_the_ports_checkpoint(tmp_path, jax_single):
    ckdir = str(tmp_path / "ck")
    ref, _ = _port_run(tmp_path, "single", 6)
    _port_run(tmp_path, "single", 3, ckdir)
    host0, jstep, jdata = jax_single
    res = jrun_training(jstep, jax.tree.map(jnp.asarray, host0), jdata,
                        JLoopConfig(total_steps=6, checkpoint_every=100,
                                    checkpoint_dir=ckdir, log_every=1))
    assert res.resumed_from == 3
    np.testing.assert_allclose([h["loss"] for h in res.history],
                               [h["loss"] for h in ref.history[3:]],
                               rtol=2e-5)
    jflat = {k: v for k, v in jck._flatten(res.state).items()
             if k.startswith("['params']")}
    tflat = {k: v for k, v in _port_flat(ref.state).items()
             if k.startswith("['params']")}
    assert jflat.keys() == tflat.keys()
    assert _rel_norm(tflat, jflat) < 2e-4
