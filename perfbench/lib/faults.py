"""Faults planted in the program's timed path, for the tests that see a
run's ``correct`` come out false and for the fault readings that set the
upper end of a limit (``control.py --plant``). Each is ``(wrap,
patch)``: ``wrap`` wraps the driver's step or render function,
``patch(setattr)`` replaces a program function (``setattr(module, name,
value)``, undone by the caller). One chip: no exchange between chips to
leave out."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np


def _unchanged_step(step):
    """A step that returns its state unchanged."""
    def run(params, opt, *a, **kw):
        before = {k: p.detach().clone() for k, p in params.items()}
        out = step(params, opt, *a, **kw)
        for k, p in params.items():
            p.data.copy_(before[k])
        return out
    return run


def _altered_loss(step):
    """The loss altered by 1% where it is produced."""
    def run(*a, **kw):
        loss, grads = step(*a, **kw)
        return loss * 1.01, grads
    return run


def _half_pixels(setattr_):
    """Half of the pixels left out, the mean taken over the rest: the
    whole frame's pixel order cut in half, and half the tiles drawn."""
    from yhair_tpu_torch.parallel import mesh
    perm_fn, draw = mesh.tile_pixel_permutation, mesh.draw_tiles

    def half(width, height, *a, **kw):
        perm, inv = perm_fn(width, height, *a, **kw)
        return perm[:perm.size // 2], inv
    setattr_(mesh, "tile_pixel_permutation", half)
    setattr_(mesh, "draw_tiles",
             lambda n, k, gen: draw(n, max(1, k // 2), gen))


def _unchanged_image(setattr_):
    """Passes that leave the accumulated image unchanged."""
    from yhair_tpu_torch.apps import common
    render_pass = common.render_pass
    setattr_(common, "render_pass", lambda *a, **kw: render_pass(*a, **kw)
             * 0.0)


def _half_samples(render):
    """Half of each pixel's samples left out, the mean over the rest. At
    one sample a pixel: the samples of every other pixel of a row left
    out, each pair of pixels taking the one sample kept."""
    def run(sc, cam, width, height, spp, *a, **kw):
        if spp > 1:
            return render(sc, cam, width, height, spp // 2, *a, **kw)
        img = np.array(render(sc, cam, width, height, spp, *a, **kw))
        img[:, 1::2] = img[:, 0::2][:, :width // 2]
        return img
    return run


def _altered_image(render):
    """The image altered by 1% where it is produced."""
    def run(*a, **kw):
        return np.asarray(render(*a, **kw)) * 1.01
    return run


FAULTS = {
    "invert": {"unchanged": (_unchanged_step, None),
               "half": (None, _half_pixels),
               "altered": (_altered_loss, None)},
    "render": {"unchanged": (None, _unchanged_image),
               "half": (_half_samples, None),
               "altered": (_altered_image, None)},
}


@contextmanager
def planted(kind, name, driver=None):
    """Fault ``name`` of a traffic kind planted for the block: its patch
    applied and undone after; yields its wrapper of the timed path (or
    None). A driver file may bring its own ``FAULTS`` table."""
    wrap, patch = (getattr(driver, "FAULTS", None) or FAULTS[kind])[name]
    undo = []

    def set_(module, attr, value):
        undo.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)
    if patch is not None:
        patch(set_)
    try:
        yield wrap
    finally:
        for module, attr, value in reversed(undo):
            setattr(module, attr, value)
