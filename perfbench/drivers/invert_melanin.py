"""Traffic kind ``invert_melanin``: the ``invert`` kind's closed loop of
Adam steps through ``parallel/mesh.train_step_fn``, with the melanin
concentrations ``eumelanin`` and ``pheomelanin`` among the leaves: the
step maps them to the scene's sigma_a under autograd, so the gradient
reaches them through the hair absorption.

The concentrations' truth is the configuration generator's
``eumelanin`` and ``pheomelanin`` arguments (the scene holds only the
sigma_a they give), the other leaves' the scene's hair material; each
starts at ``init_scale`` times its truth. The step loop, the readings
and the leaf gaps are the ``invert`` kind's (``invert.py`` beside this
file); the reference is ``reference/melanin.train_steps``.

Faults (``control.py --plant``): ``detached``, the step maps sigma_a
from detached concentrations, so their gradients are 0; ``swapped``,
the eumelanin and pheomelanin constants exchanged.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _invert():
    """A copy of its own of the ``invert`` kind's file beside this one,
    by its path (these files are loaded by path and form no package):
    its ``initial_params`` and ``reference`` are rebound to this kind's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "perfbench_driver_invert_of_melanin",
        Path(__file__).with_name("invert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_inv = _invert()
UNIT = _inv.UNIT
samples_per_unit = _inv.samples_per_unit
tiny = _inv.tiny
unit = _inv.unit
release = _inv.release
failed_units = _inv.failed_units
MELANIN = ("eumelanin", "pheomelanin")


def initial_params(run, scene_d):
    """float32 of init_scale times each leaf's float64 truth."""
    w = run.workload
    truth = dict(scene_d["hair_material"])
    kw = run.config["generator"]["kwargs"]
    truth.update({k: kw[k] for k in MELANIN})
    return {k: (np.asarray(truth[k], np.float64) * w["init_scale"])
            .astype(np.float32) for k in w["params"]}


def setup(run, fault=None):
    """The ``invert`` kind's set-up (scene, target, leaves, Adam, the
    step and its warm steps), starting from this kind's values."""
    _inv.initial_params = lambda scene_d, w: initial_params(run, scene_d)
    return _inv.setup(run, fault)


def reference(st, w, device, dtype=torch.float32):
    """The reference's loss, first gradient and parameters over the warm
    steps, from the same scene dict, target, initial values and seed."""
    from perfbench.reference import melanin

    n = w["warm_steps"]
    out = melanin.train_steps(st.scene_d, st.cam_d,
                              torch.as_tensor(st.target_np), w, st.seed, n,
                              device, dtype, init=st.init)
    return {"loss": out["loss"],
            "grad1": {k: v.cpu().numpy() for k, v in out["grad1"].items()},
            "params": {k: v.cpu().numpy()
                       for k, v in out["params"][n - 1].items()},
            "init": st.init}


# the copy's check and control call this kind's reference (and its
# set-up this kind's initial_params)
_inv.reference = reference
check = _inv.check
control = _inv.control


def _detached(setattr_):
    """sigma_a mapped from detached concentrations."""
    from yhair_tpu_torch.bsdf import hair
    to_sigma_a = hair.sigma_a_from_concentration
    setattr_(hair, "sigma_a_from_concentration",
             lambda ce, cp: to_sigma_a(ce.detach(), cp.detach()))


def _swapped(setattr_):
    """The eumelanin and pheomelanin constants exchanged."""
    from yhair_tpu_torch.bsdf import hair
    to_sigma_a = hair.sigma_a_from_concentration
    setattr_(hair, "sigma_a_from_concentration",
             lambda ce, cp: to_sigma_a(cp, ce))


FAULTS = {"detached": (None, _detached), "swapped": (None, _swapped)}
