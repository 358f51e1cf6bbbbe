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
Restore places each leaf on the device and dtype of the target's leaf:
the reference reshards onto another mesh (elastic restore); with one
device its counterpart is restoring onto another device (a checkpoint
saved from ``cuda`` restored onto the CPU, or back).

Saves run on a background thread after a synchronous copy of every leaf
to the host (so the caller may update its tensors in place at once); the
previous save is awaited before the next starts.  ``keep`` bounds the
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

# bfloat16, which numpy cannot hold, is stored as its 16 bits
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the order ``_unflatten`` consumes them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
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


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, true_dtype = _as_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "dtype": true_dtype,
                                   "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)  # atomic publish: partial saves are never visible
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if p.is_dir() and p.suffix != ".tmp")
    return steps[-1] if steps else None


def _restore_leaf(arr: np.ndarray, dtype_name: str, target: Any) -> Any:
    """A saved array as the target leaf's kind: a tensor on the target's
    device and dtype, an array of its dtype, or a Python number."""
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
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target``, each leaf on the device
    and dtype of the target's (any device: cross-device restore)."""
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
    out = [_restore_leaf(np.load(d / spec["file"]), spec["dtype"], tgt)
           for spec, (_, tgt) in zip(manifest["leaves"], flat)]
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
             blocking: bool = False) -> None:
        self.wait()
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

    def restore_latest(self, target: Any):
        self.wait()
        return restore_checkpoint(str(self.dir), target)
