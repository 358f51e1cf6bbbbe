"""Deterministic synthetic data pipeline (numpy only).

The port of the JAX package's ``data/pipeline.py``: the same tokens for
every ``(seed, step, rank, world)``.  Batches are a pure function of (seed,
step) — no iterator state — so a restart from a checkpoint resumes on
exactly the batch it would have seen, and each data-parallel rank slices
its share of the global batch on its own.

The stream is a mixture of structured patterns (a Markov chain over a
random table) so a small model has something to learn and the loss visibly
decreases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    markov_states: int = 64


def _markov_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, cfg.vocab_size, size=(cfg.markov_states, 8))


def batch_at(cfg: DataConfig, step: int, *, rank: int = 0,
             world: int = 1) -> Dict[str, np.ndarray]:
    """The (rank-th slice of the) global batch for ``step``: ``tokens``
    and ``labels`` (per, seq_len) int32, ``loss_mask`` float32 ones."""
    if cfg.global_batch % world:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {world} ranks")
    per = cfg.global_batch // world
    rng = np.random.default_rng((cfg.seed, step, rank))
    table = _markov_table(cfg)
    k = table.shape[0]
    state = rng.integers(0, k, size=(per,))
    toks = np.empty((per, cfg.seq_len + 1), np.int32)
    for t in range(cfg.seq_len + 1):
        choice = rng.integers(0, table.shape[1], size=(per,))
        toks[:, t] = table[state, choice]
        state = (state * 31 + toks[:, t]) % k
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
        "loss_mask": np.ones((per, cfg.seq_len), np.float32),
    }


def side_inputs(mcfg, cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The stubbed frontends' inputs of ``step``'s global batch for the
    model config ``mcfg``, which the JAX package's pipeline does not make
    (its trainer runs the token families only): ``frames`` (global_batch,
    enc_frames, d_model) for the ``encdec`` family, ``patch_embeds``
    (global_batch, vision_patches, d_model) for the ``vlm`` family,
    standard normal float32 draws from (seed, step); nothing for the other
    families."""
    name, rows = {"encdec": ("frames", mcfg.enc_frames),
                  "vlm": ("patch_embeds", mcfg.vision_patches)
                  }.get(mcfg.family, (None, 0))
    if name is None:
        return {}
    rng = np.random.default_rng((cfg.seed, step, 1))
    return {name: rng.standard_normal((cfg.global_batch, rows, mcfg.d_model))
            .astype(np.float32)}


def data_iter(cfg: DataConfig, start_step: int = 0, *, rank: int = 0,
              world: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, rank=rank, world=world)
        step += 1
