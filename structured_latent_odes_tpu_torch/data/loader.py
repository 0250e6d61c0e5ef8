"""Host-side minibatch pipeline copied from the JAX package's
``data/loader.py``: the model layout permutation, normalization, static-size
padding with a per-sample ``mask``, the minibatch iterators and the stacked
whole-epoch layout. Each batch carries ``sample_id``, the sample's index in
its split, which keys its random draws.

``stacked_minibatches`` packs its float32 arrays with the native packer
(``native.pack_epoch_native``) where the library loads, and gathers with
numpy indexing otherwise; the values are the same.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from structured_latent_odes_tpu_torch import native

Split = Dict[str, np.ndarray]


def to_model_layout(split: Split) -> Split:
    """(N, T, K) observations -> (N, K, T); labels pass through."""
    out = dict(split)
    out["observations"] = np.ascontiguousarray(np.swapaxes(split["observations"], -1, -2))
    return out


def normalize_split(split: Split, transforms) -> Split:
    out = dict(split)
    obs = split["observations"]
    for t in transforms.values():
        obs = t(obs)
    out["observations"] = obs
    return out


def pad_to(split: Split, size: int) -> Split:
    """Pad every array's leading dim to ``size`` and attach a 0/1 mask."""
    n = split["observations"].shape[0]
    if n > size:
        raise ValueError(f"split has {n} samples, more than the pad size {size}")
    out = {}
    for k, v in split.items():
        if k == "mask":
            continue
        pad = np.zeros((size - n,) + v.shape[1:], dtype=v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    out["mask"] = mask
    return out


def random_crop(split: Split, crop_len: int, rng: Optional[np.random.RandomState] = None) -> Split:
    """Per-sample random time crop to ``crop_len`` of ``(N, K, T)``
    observations (the reference Dataset's dormant ``random_start``)."""
    obs = split["observations"]
    T = obs.shape[-1]
    if crop_len >= T:
        return split
    starts = (rng if rng is not None else np.random).randint(0, T - crop_len + 1, size=obs.shape[0])
    idx = starts[:, None, None] + np.arange(crop_len)[None, None, :]
    out = dict(split)
    out["observations"] = np.take_along_axis(obs, np.broadcast_to(idx, obs.shape[:2] + (crop_len,)), axis=2)
    return out


def iter_minibatches(
    split: Split,
    batch_size: int,
    *,
    shuffle: bool,
    rng: Optional[np.random.RandomState] = None,
    pad: bool = True,
    crop_len: Optional[int] = None,
) -> Iterator[Split]:
    """Yield static-shape minibatches (the last one padded and masked)."""
    if crop_len is not None:
        split = random_crop(split, crop_len, rng)
    n = split["observations"].shape[0]
    idx = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(idx)
    for start in range(0, n, batch_size):
        sel = idx[start : start + batch_size]
        batch = {k: v[sel] for k, v in split.items()}
        batch["sample_id"] = sel.astype(np.int32)
        if pad and len(sel) < batch_size:
            batch = pad_to(batch, batch_size)
        else:
            batch["mask"] = np.ones((len(sel),), dtype=np.float32)
        yield batch


def stacked_minibatches(
    split: Split,
    batch_size: int,
    *,
    shuffle: bool,
    rng: Optional[np.random.RandomState] = None,
    crop_len: Optional[int] = None,
) -> Split:
    """The whole epoch as one dict with leading ``(n_batches, batch_size,
    ...)`` axes and a per-sample mask; padding rows repeat sample 0, masked
    out."""
    if crop_len is not None:
        split = random_crop(split, crop_len, rng)
    n = split["observations"].shape[0]
    idx = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(idx)
    n_batches = -(-n // batch_size)
    padded = n_batches * batch_size
    sel = np.concatenate([idx, np.zeros(padded - n, dtype=int)])
    mask = np.zeros(padded, dtype=np.float32)
    mask[:n] = 1.0
    out = {}
    for k, v in split.items():
        if k == "mask":
            continue
        packed = native.pack_epoch_native(v, sel, padded) if v.dtype == np.float32 else None
        if packed is None:
            packed = v[sel]
        out[k] = packed.reshape((n_batches, batch_size) + v.shape[1:])
    out["mask"] = mask.reshape(n_batches, batch_size)
    out["sample_id"] = sel.astype(np.int32).reshape(n_batches, batch_size)
    return out


def full_batch(split: Split, pad_to_size: Optional[int] = None) -> Split:
    out = dict(split)
    n = out["observations"].shape[0]
    out["sample_id"] = np.arange(n, dtype=np.int32)
    if pad_to_size is not None and n < pad_to_size:
        out = pad_to(out, pad_to_size)
    else:
        out["mask"] = np.ones((n,), dtype=np.float32)
    return out
