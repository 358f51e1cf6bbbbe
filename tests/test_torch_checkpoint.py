"""The port's checkpointing, following the reference's
``tests/test_checkpoint.py``: a bit-exact round trip (bfloat16 included),
``latest_step`` and retention, an async save then restore; and the
on-disk layout against the JAX package's: the same manifest keys, leaf
names, dtypes and shapes, and each package restoring what the other
wrote, bit for bit."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro_torch.checkpoint.checkpointing import (CheckpointManager,
                                                  latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)
from repro_torch.training.optimizer import AdamState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g),
            "b16": torch.randn((4, 4), generator=g).to(torch.bfloat16),
            "nested": {"step": torch.tensor(7, dtype=torch.int32),
                       "m": torch.ones((3, 5))}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


def test_roundtrip_bit_exact(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, {"step": 3})
    restored, extra = restore_checkpoint(str(tmp_path), t)
    assert extra["step"] == 3
    for a, b in zip(_leaves(t), _leaves(restored)):
        _same(a, b)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), {"step": s}, blocking=True)
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]
    assert latest_step(str(tmp_path / "none")) is None


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(9)
    before = t["w"].clone()
    mgr.save(5, t, {"step": 5})          # async
    t["w"].add_(1.0)                     # the save took its own copy
    restored, extra = mgr.restore_latest(t)
    assert extra["step"] == 5
    _same(restored["w"], before)


def test_restores_an_adam_state_and_checks_the_tree(tmp_path):
    params = {"a": torch.randn(3, 4), "b": torch.randn(4)}
    state = AdamState(torch.tensor(11, dtype=torch.int32),
                      {n: p * 2 for n, p in params.items()},
                      {n: (p * 3).to(torch.bfloat16)
                       for n, p in params.items()})
    save_checkpoint(str(tmp_path), 11, (params, state), {"step": 11})
    (p2, s2), _ = restore_checkpoint(str(tmp_path), (params, state))
    assert isinstance(s2, AdamState) and int(s2.step) == 11
    for a, b in zip(_leaves((params, state)), _leaves((p2, s2))):
        _same(a, b)
    with pytest.raises(ValueError, match="tree mismatch"):
        restore_checkpoint(str(tmp_path), ({"a": params["a"]}, state))


def test_restore_onto_the_targets_dtype_and_device(tmp_path):
    """A leaf lands on the target's device and dtype (the one-device
    counterpart of the reference's elastic reshard)."""
    t = _tree(2)
    save_checkpoint(str(tmp_path), 0, t)
    target = {"w": torch.zeros((16, 8), dtype=torch.float64),
              "b16": torch.zeros((4, 4), dtype=torch.float32),
              "nested": {"step": np.zeros((), np.int64),
                         "m": np.zeros((3, 5), np.float64)}}
    out, _ = restore_checkpoint(str(tmp_path), target)
    assert out["w"].dtype == torch.float64
    torch.testing.assert_close(out["w"], t["w"].double(), rtol=0, atol=0)
    torch.testing.assert_close(out["b16"], t["b16"].float(), rtol=0, atol=0)
    assert out["nested"]["step"].dtype == np.int64
    assert out["nested"]["step"] == 7


def _jax_tree(t):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else x.numpy().dtype),
        t)


def test_manifest_matches_the_reference(tmp_path):
    t = _tree(4)
    save_checkpoint(str(tmp_path / "port"), 3, t, {"step": 3})
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3, _jax_tree(t),
                             {"step": 3})
    read = lambda d: json.loads(  # noqa: E731
        (tmp_path / d / "step_00000003" / "manifest.json").read_text())
    port, ref = read("port"), read("jax")
    assert set(port) == set(ref) == {"step", "extra", "leaves"}
    assert port["step"] == ref["step"] and port["extra"] == ref["extra"]
    assert port["leaves"] == ref["leaves"]
    assert {leaf["dtype"] for leaf in port["leaves"]} >= {"bfloat16"}


def test_each_package_restores_the_others_checkpoint(tmp_path):
    t = _tree(5)
    jt = _jax_tree(t)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, jt, {"step": 1})
    got, extra = restore_checkpoint(str(tmp_path / "jax"), t)
    assert extra == {"step": 1}
    for a, b in zip(_leaves(t), _leaves(got)):
        _same(a, b)
    save_checkpoint(str(tmp_path / "port"), 2, t, {"step": 2})
    back, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), jt)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
