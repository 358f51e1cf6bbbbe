"""Manifest-based checkpointing with async save and bounded retention.

The port of the JAX package's ``checkpoint/checkpointing.py``, with its
on-disk layout: ``<dir>/step_<N>/manifest.json`` plus one ``.npy`` per
leaf, written into ``step_<N>.tmp`` and then renamed, so a partial save is
never visible.  The manifest holds ``step``, ``extra`` and, per leaf, its
``name`` (the path of dict keys and sequence indices, joined by ``/``),
``file``, ``dtype`` and ``shape``.  numpy cannot store bfloat16, so such a
leaf is written as its ``uint16`` bits (a ``torch`` view) with the true
dtype in the manifest.

A tree is nested dicts (flattened in sorted key order), tuples, lists and
named tuples (``AdamState``) of tensors, arrays or Python numbers.
Restore places each leaf on the device and dtype of the target's leaf,
which may be another device than the save's (a checkpoint saved from
``cuda`` restored onto the CPU, or back).

Over a process mesh (``mesh=``, a ``ProcessMesh``, with ``shardings=``: a
tree of the target's structure whose leaves are specs, ``P`` or
``None``) the tree's tensors are this rank's blocks.  A save gathers each
leaf whole onto rank 0 (every rank's block, leaf by leaf), which writes
it: the reference's single-host layout and manifest; every rank waits until
the checkpoint is published.  A restore loads each leaf whole and keeps
this rank's block under the target's spec: the mesh may have another
shape than the save's (the reference's elastic restore), and a checkpoint
the JAX package wrote restores the same way.

Saves run on a background thread after a synchronous copy of every leaf
to the host (so the caller may update its tensors in place at once); the
previous save is awaited before the next starts.  Over a process mesh the
save is synchronous (its gathers are collectives).  ``keep`` bounds the
checkpoints retained.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (P, block_slices, gather_whole,
                                              spec_axes)

# bfloat16, which numpy cannot hold, is stored as its 16 bits
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the order ``_unflatten`` consumes them (a
    spec ``P`` is a leaf)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(tree: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in tree]
        if hasattr(tree, "_fields"):            # a named tuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return next(leaves)


def _to_host(leaf: Any) -> Any:
    """A host copy of a leaf (a CPU tensor is copied too, so the caller's
    in-place updates do not reach a save in flight)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _as_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """The array to write and the leaf's true dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name == _BF16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _specs(tree: Any, shardings: Any) -> List[Optional[tuple]]:
    """Each leaf's spec, in ``_flatten`` order (``None``: replicated)."""
    flat = _flatten(tree)
    if shardings is None:
        return [None] * len(flat)
    specs = _flatten(shardings)
    if [n for n, _ in specs] != [n for n, _ in flat]:
        raise ValueError("shardings do not have the tree's structure")
    return [s if s is not None and spec_axes(s) else None for _, s in specs]


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived (a sum over each axis in turn
    reaches every rank)."""
    from repro_torch.distributed.collectives import all_reduce_over
    all_reduce_over(torch.ones((), device=mesh.device), mesh)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None, *,
                    mesh=None, shardings: Any = None) -> Path:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``; over a process
    ``mesh`` its leaves are blocks under ``shardings``, gathered whole and
    written by rank 0 (the module docstring)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    writer = mesh is None or mesh.rank == 0
    if writer:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    specs = _specs(tree, shardings if mesh is not None else None)
    for i, ((name, leaf), spec) in enumerate(zip(_flatten(tree), specs)):
        if spec is not None:
            leaf = gather_whole(leaf, spec, mesh)
        if not writer:
            continue
        arr, true_dtype = _as_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "dtype": true_dtype,
                                   "shape": list(arr.shape)})
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)  # atomic publish: partial saves are never visible
    if mesh is not None:
        _barrier(mesh)
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if p.is_dir() and p.suffix != ".tmp")
    return steps[-1] if steps else None


def _restore_leaf(arr: np.ndarray, dtype_name: str, target: Any,
                  spec=None, mesh=None) -> Any:
    """A saved array as the target leaf's kind: a tensor on the target's
    device and dtype (with ``spec``: this rank's block of it), an array of
    its dtype, or a Python number."""
    if spec is not None:        # a copy of the block of a memory map
        arr = np.array(arr[block_slices(arr.shape, spec, mesh)])
        if isinstance(target, torch.Tensor) and \
                tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"a block of {tuple(arr.shape)} for a target "
                             f"of {tuple(target.shape)}")
    arr = np.ascontiguousarray(arr).reshape(arr.shape)    # keeps 0-d
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
         if dtype_name == _BF16 else torch.from_numpy(arr))
    if isinstance(target, torch.Tensor):
        return t.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return (t.float() if dtype_name == _BF16 else t).numpy().astype(
            target.dtype)
    return t.item()


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None, shardings: Any = None,
                       mesh=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target``, each leaf on the device
    and dtype of the target's (any device: cross-device restore); over a
    process ``mesh``, each leaf's block under ``shardings`` (the module
    docstring)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = _flatten(target)
    names = [n for n, _ in flat]
    saved = [s["name"] for s in manifest["leaves"]]
    if names != saved:
        first = next(i for i, (a, b) in enumerate(zip(names + [None],
                                                      saved + [None]))
                     if a != b)
        raise ValueError(f"tree mismatch: {len(names)} leaves vs "
                         f"{len(saved)} saved; leaf {first} differs")
    specs = _specs(target, shardings if mesh is not None else None)
    out = [_restore_leaf(np.load(d / spec["file"],
                                 mmap_mode=None if sh is None else "r"),
                         spec["dtype"], tgt, sh, mesh)
           for spec, (_, tgt), sh in zip(manifest["leaves"], flat, specs)]
    return _unflatten(target, iter(out)), manifest["extra"]


class CheckpointManager:
    """Async saver with bounded retention."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False, *, mesh=None,
             shardings: Any = None) -> None:
        """Save ``tree`` (in the background unless ``blocking``; over a
        process ``mesh``, its blocks under ``shardings``, synchronously)."""
        self.wait()
        if mesh is not None:
            save_checkpoint(str(self.dir), step, tree, extra, mesh=mesh,
                            shardings=shardings)
            if mesh.rank == 0:
                self._gc()
            _barrier(mesh)
            self.save_count += 1
            return
        host_tree = _unflatten(tree, iter([_to_host(x)
                                           for _, x in _flatten(tree)]))

        def _work():
            save_checkpoint(str(self.dir), step, host_tree, extra)
            self._gc()

        self.save_count += 1
        if blocking:
            _work()
        else:
            self._thread = threading.Thread(target=_work, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if p.is_dir() and p.suffix != ".tmp")
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def restore_latest(self, target: Any, shardings: Any = None,
                       mesh=None):
        self.wait()
        return restore_checkpoint(str(self.dir), target,
                                  shardings=shardings, mesh=mesh)
