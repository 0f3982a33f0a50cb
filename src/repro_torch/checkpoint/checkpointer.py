"""Fault-tolerant checkpointer: atomic, async, integrity-checked, in the
JAX package's on-disk format.

Layout:  <dir>/step_<n>/
            arrays.npz        flattened state tree (key string -> array)
            manifest.json     step, key list, per-array crc32, metadata
The manifest is written LAST and fsync'd; restore ignores directories
without a valid manifest, so a crash mid-save never corrupts a resume.

The keys are the JAX package's: ``jax.tree_util.keystr`` of each leaf's
path through nested dicts (``['params']['stem']['conv']``), built here
in plain Python, with the keys of every dict visited in sorted order as
JAX flattens them. A tree whose leaves are laid out as the JAX
package's (``interop.train_state_to_jax``) therefore writes the file
that package writes, and reads its files back. bfloat16 tensors are
stored as numpy has no bfloat16: as raw 2-byte void elements (``|V2``),
the bytes and dtype the JAX package's ``np.savez`` of an ``ml_dtypes``
array writes.

Atomic replace: a re-save of an existing step moves the old directory
aside, renames the temporary directory in, fsyncs the parent and only
then deletes the old copy; an exception moves the old copy back. Stale
``.tmp_ckpt_*`` / ``.old_ckpt_*`` directories of killed runs are
removed when an ``AsyncCheckpointer`` opens the directory.

Integrity: the manifest carries a crc32 per array. ``restore`` checks
the payload (zip structure, key coverage, checksums) and, asked for the
newest checkpoint, falls back to the next-newest intact one, reporting
each corrupt candidate through ``on_corrupt``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Any

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
_TMP_PREFIX = ".tmp_ckpt_"
_ASIDE_PREFIX = ".old_ckpt_"
_BF16_VOID = np.dtype("V2")


class CheckpointCorruptError(RuntimeError):
    """The checkpoint's payload failed validation (torn/bit-flipped
    arrays.npz, missing keys, or a crc32 mismatch)."""


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys:
    ``("params", "fc", "w")`` -> ``"['params']['fc']['w']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves(tree: Tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in the JAX package's flatten order: the keys of
    every dict in sorted order, depth first."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array, a copy for a tensor (also for one
    on the CPU, which the next step may update in place); bfloat16 as
    the JAX package writes it."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_VOID)
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A checkpoint array as a tensor of ``like``'s dtype and device."""
    arr = np.asarray(arr)
    if arr.dtype == _BF16_VOID:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {keystr(path): to_numpy(leaf) for path, leaf in _leaves(tree)}


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: str):
    """Durably record a rename in the parent directory (best effort:
    some filesystems reject O_RDONLY fsync on directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def gc_stale_tmpdirs(directory: str) -> int:
    """Remove ``.tmp_ckpt_*`` / aside directories left behind by killed
    runs. Call only when no save can be in flight in ``directory`` (a
    fresh ``AsyncCheckpointer`` does, at open). Returns the count."""
    if not os.path.isdir(directory):
        return 0
    n = 0
    for name in os.listdir(directory):
        if name.startswith((_TMP_PREFIX, _ASIDE_PREFIX)):
            shutil.rmtree(os.path.join(directory, name),
                          ignore_errors=True)
            n += 1
    return n


def _write_checkpoint(directory: str, step: int,
                      arrays: Dict[str, np.ndarray],
                      metadata: Optional[Dict] = None) -> str:
    """Write already-flattened host arrays as ``step_<n>`` atomically."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=directory)
    aside = None
    try:
        np.savez(os.path.join(tmp, ARRAYS), **arrays)
        manifest = {
            "step": int(step),
            "keys": sorted(arrays.keys()),
            "crc32": {k: _crc32(v) for k, v in arrays.items()},
            "metadata": metadata or {},
        }
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            # move the existing good checkpoint aside, never delete it
            # before its replacement is in place
            aside = tempfile.mkdtemp(prefix=_ASIDE_PREFIX, dir=directory)
            os.rmdir(aside)
            os.rename(final, aside)
        os.rename(tmp, final)
        _fsync_dir(directory)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
            aside = None
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if aside is not None and not os.path.exists(final):
            os.rename(aside, final)  # restore the previous good copy
        elif aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        raise
    return final


def save(directory: str, step: int, state: Tree,
         metadata: Optional[Dict] = None) -> str:
    """Atomic synchronous save. Returns the checkpoint path."""
    return _write_checkpoint(directory, step, _flatten(state), metadata)


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one save in flight.

    The state is snapshotted to host arrays **once**, on the caller's
    thread (``_flatten``: a synchronous device-to-host copy of every
    tensor leaf), so the training loop may update its tensors in place
    as soon as ``save`` returns; the worker thread serializes that same
    dict. An error of the write surfaces on the next ``wait()`` (or
    ``save``). Opening a directory removes stale temporary directories
    of killed runs.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        gc_stale_tmpdirs(directory)

    def save(self, step: int, state: Tree, metadata=None,
             block: bool = False):
        self.wait()
        arrays = _flatten(state)  # the ONE host snapshot

        def _worker():
            try:
                _write_checkpoint(self.directory, step, arrays, metadata)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        _gc_dir(self.directory, self.keep)


def _gc_dir(directory: str, keep: int):
    """Drop all but the newest ``keep`` checkpoints in ``directory``: the
    one retention policy, shared by the rotating window and the
    best-checkpoint directory (keep=1)."""
    steps = list_checkpoints(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


BEST_DIR = "best"


def save_best(directory: str, step: int, state: Tree,
              metadata: Optional[Dict] = None) -> str:
    """Retain ``state`` as the best checkpoint so far, under
    ``<directory>/best/step_<n>``: outside the rotating ``keep`` window,
    so the best-accuracy state survives its GC. At most one best
    checkpoint exists; the previous one is removed after the new one is
    atomically in place."""
    bdir = os.path.join(directory, BEST_DIR)
    path = save(bdir, step, state, metadata=metadata)
    _gc_dir(bdir, keep=1)
    return path


def restore_best(directory: str, target: Optional[Tree] = None,
                 transform=None) -> Tuple[Tree, Dict]:
    """Restore the retained best checkpoint (see ``save_best``)."""
    return restore(os.path.join(directory, BEST_DIR), target=target,
                   transform=transform)


def list_checkpoints(directory: str):
    """Steps with a parseable manifest AND a present payload: a torn
    save missing ``arrays.npz`` must not be offered for resume (deep
    payload validation happens in ``restore``)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        if not os.path.exists(os.path.join(directory, name, ARRAYS)):
            continue  # payload never landed: skip
        if os.path.exists(os.path.join(directory, name, MANIFEST)):
            try:
                with open(os.path.join(directory, name, MANIFEST)) as f:
                    json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # partial/corrupt save: skip
            out.append(int(m.group(1)))
    return sorted(out)


def _load_arrays(path: str, manifest: Dict) -> Dict[str, np.ndarray]:
    """Load + validate one checkpoint's payload against its manifest.
    Raises ``CheckpointCorruptError`` on any integrity failure."""
    try:
        with np.load(os.path.join(path, ARRAYS)) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:  # zipfile/np errors on torn or flipped bytes
        raise CheckpointCorruptError(
            f"unreadable {ARRAYS} under {path}: {e}") from e
    missing = [k for k in manifest.get("keys", []) if k not in arrays]
    if missing:
        raise CheckpointCorruptError(
            f"{path} payload lost {len(missing)} arrays "
            f"(first: {missing[0]!r})")
    crcs = manifest.get("crc32")
    if crcs:  # absent in pre-integrity checkpoints: skip verification
        for k, want in crcs.items():
            if k in arrays and _crc32(arrays[k]) != want:
                raise CheckpointCorruptError(
                    f"crc32 mismatch for {k!r} under {path}")
    return arrays


def _set_path(tree: Dict, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def restore(directory: str, step: Optional[int] = None,
            target: Optional[Tree] = None,
            transform=None,
            on_corrupt: Optional[Callable[[int, Exception], None]] = None
            ) -> Tuple[Tree, Dict]:
    """Restore ``step`` (default: newest intact). Without ``target`` it
    returns the flat ``{key string: array}`` dict and the manifest; with
    ``target`` (nested dicts of tensors, arrays or numbers) the arrays
    are unflattened into its structure, each leaf taking the target
    leaf's dtype (and device, for a tensor).

    With ``step=None`` the candidates are tried newest-first and a
    corrupt payload (torn write, flipped bytes, crc mismatch) makes the
    restore fall back to the next-newest intact checkpoint, reporting
    each skipped candidate through ``on_corrupt(step, error)``. An
    explicitly requested ``step`` still raises on corruption.

    ``transform(arrays, manifest) -> arrays`` rewrites the loaded array
    dict before key matching (a layout hook)."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no valid checkpoint under {directory}")
    candidates = [step] if step is not None else list(reversed(steps))
    arrays = manifest = None
    last_err: Optional[Exception] = None
    for s in candidates:
        path = os.path.join(directory, f"step_{s:010d}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        try:
            arrays = _load_arrays(path, manifest)
            break
        except CheckpointCorruptError as e:
            if step is not None:
                raise
            last_err = e
            if on_corrupt is not None:
                on_corrupt(s, e)
    else:
        raise CheckpointCorruptError(
            f"no intact checkpoint under {directory}: every candidate "
            f"failed validation (last: {last_err})")
    if transform is not None:
        arrays = transform(arrays, manifest)
    if target is None:
        return arrays, manifest
    tree: Dict = {}
    for path, leaf in _leaves(target):
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"target {want}")
        if torch.is_tensor(leaf):
            value = to_tensor(arr, leaf)
        elif isinstance(leaf, (int, float, bool)):
            value = type(leaf)(arr.item())
        else:
            value = np.asarray(arr).astype(np.asarray(leaf).dtype)
        _set_path(tree, path, value)
    return tree, manifest
