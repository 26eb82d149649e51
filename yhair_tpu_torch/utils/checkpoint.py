"""Checkpoint and resume of progressive renders and inverse-rendering
runs (``yhair_tpu/utils/checkpoint.py``).

Every sample's uniforms come from (pixel, sample, dimension) counters,
so a render's state is ``(accum, next_sample, seed)`` and a resumed
render equals an uninterrupted one bit for bit. The render state is the
reference's .npz (the same keys and ``FORMAT_VERSION``): a render
checkpointed by either package resumes in the other.

A training run's state is the port's own file (``torch.save``): the
parameter tensors, the optimizer's ``state_dict()``, the step, the seed,
the state of the ``torch.Generator`` that draws the pixel batches,
which advances every step, so a resumed run draws the tiles an
uninterrupted one would, and the loss of every step taken so far.
"""

from __future__ import annotations

import os

import numpy as np
import torch

FORMAT_VERSION = 1


def save_render_state(path, accum, next_sample, seed, meta=None):
    """accum: (H, W, 3) SUM of per-sample radiance for samples
    [0, next_sample); divide by next_sample for the current image."""
    tmp = str(path) + ".tmp.npz"
    np.savez_compressed(
        tmp, version=FORMAT_VERSION, accum=np.asarray(accum, np.float64),
        next_sample=int(next_sample), seed=int(seed),
        meta=np.asarray(repr(meta or {})))
    os.replace(tmp, path)


def _check_version(version, path):
    if int(version) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {int(version)}, this "
                         f"program reads {FORMAT_VERSION}")


def load_render_state(path):
    with np.load(path, allow_pickle=False) as z:
        _check_version(z["version"], path)
        return {
            "accum": z["accum"],
            "next_sample": int(z["next_sample"]),
            "seed": int(z["seed"]),
        }


def save_train_state(path, params, opt, step, seed, generator=None,
                     losses=None):
    """params: {name: tensor}; opt: a ``torch.optim`` optimizer over
    them; generator: the pixel-batch ``torch.Generator`` (or None);
    losses: the loss of each step taken (floats, or None)."""
    tmp = str(path) + ".tmp"
    torch.save({
        "version": FORMAT_VERSION, "step": int(step), "seed": int(seed),
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "optimizer": opt.state_dict(),
        "generator": None if generator is None else generator.get_state(),
        "losses": None if losses is None else [float(x) for x in losses],
    }, tmp)
    os.replace(tmp, path)


def load_train_state(path, params, opt, generator=None):
    """Restore into the given leaves, optimizer and generator, in place.
    -> (step, seed, losses): losses is None for a file saved without
    them (as before they were kept)."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    _check_version(st["version"], path)
    if set(st["params"]) != set(params):
        raise ValueError(f"{path}: holds params {sorted(st['params'])}, "
                         f"this run trains {sorted(params)}")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(st["params"][k])
    opt.load_state_dict(st["optimizer"])
    if generator is not None:
        if st["generator"] is None:
            raise ValueError(f"{path}: no pixel-batch generator state")
        generator.set_state(st["generator"])
    return st["step"], st["seed"], st.get("losses")
