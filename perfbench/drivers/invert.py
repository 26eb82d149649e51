"""Traffic kind ``invert``: an inverse-rendering job, one closed loop of
Adam steps through ``parallel/mesh.train_step_fn``, as the port's
``apps/invert`` runs them: parameters from ``init_scale`` times the
truth, step seeds from ``apps/invert.step_seed(--seed, it)``, pixel
tiles (with ``pixel_batch``) from one ``torch.Generator`` seeded with
--seed, each step's loss read back on the host.

Set-up builds the scene, the target, the parameters, the optimizer and
the step, and drives that same object through its first ``warm_steps``
steps (the first compiles and warms every shape); the window continues
it. The check: the plain reference repeats those first steps from the
same inputs; compared are each step's loss, the first gradient as Adam
received it (read back from Adam's first moment after one step) and the
parameters' change after the warm steps, each leaf's as the gap between
the two norms over the larger of the reference leaf's and the median
leaf's norm. The control: the reference in a lower precision repeats
the same steps in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

UNIT = "fwdbwd_step"


def samples_per_unit(w):
    px = w["pixel_batch"] or w["width"] * w["height"]
    return px * w["spp"]


def tiny(w):
    """The cell cut to the CPU tests' size: a 32x32 image at 2 samples a
    pixel, depth 2, 256 pixels a step where the cell draws tiles, and the
    tests' 16x16 target ``tiny.pfm``."""
    return dict(w, width=32, height=32, spp=2, max_depth=2,
                pixel_batch=w["pixel_batch"] and 256,
                target=dict(w["target"], file="tiny.pfm"))


def initial_params(scene_d, w):
    """The benchmark's starting values: float32 of init_scale times the
    scene's float64 truth, handed to both sides."""
    hm = scene_d["hair_material"]
    return {k: (np.asarray(hm[k], np.float64) * w["init_scale"])
            .astype(np.float32) for k in w["params"]}


class State:
    pass


def setup(run, fault=None):
    from yhair_tpu_torch.apps.common import build_device_scene
    from yhair_tpu_torch.parallel import mesh

    from perfbench.lib.harness import now

    w, dev = run.workload, run.device
    st = State()
    t0 = now()
    st.scene_d, st.cam_d = run.scene()
    run.note("scene generated", t0)
    t0 = now()
    st.sc, st.cam = build_device_scene(st.scene_d, st.cam_d, accel="cluster",
                                       device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.scene_build_s = now() - t0
    run.note("scene built", t0)
    t0 = now()
    st.target_np = run.target()
    st.target = torch.as_tensor(st.target_np, device=dev)
    st.init = initial_params(st.scene_d, w)
    st.params = {k: torch.tensor(v, device=dev, requires_grad=True)
                 for k, v in st.init.items()}
    st.opt = torch.optim.Adam(list(st.params.values()), lr=w["lr"])
    st.step = mesh.train_step_fn(w["width"], w["height"], w["spp"],
                                 max_depth=w["max_depth"],
                                 pixel_batch=w["pixel_batch"], device=dev)
    if fault is not None:
        st.step = fault(st.step)
    st.gen = torch.Generator().manual_seed(run.seed)
    st.seed = run.seed
    run.note("target, parameters and step made", t0)
    st.losses = []
    st.grad1 = None
    for it in range(w["warm_steps"]):
        t0 = now()
        _step(st, it)
        run.note(f"warm step {it}", t0)
        if it == 0:
            beta1 = st.opt.defaults["betas"][0]
            st.grad1 = {k: (st.opt.state[p]["exp_avg"] / (1.0 - beta1))
                        .detach().cpu().numpy() if p in st.opt.state
                        else np.zeros(p.shape, np.float32)
                        for k, p in st.params.items()}
    st.params_warm = {k: p.detach().cpu().numpy().copy()
                      for k, p in st.params.items()}
    st.window_losses = []
    return st


def _step(st, it):
    from perfbench.reference.tracer import step_seed

    loss, _ = st.step(st.params, st.opt, st.sc, st.cam, st.target,
                      step_seed(st.seed, it), generator=st.gen)
    value = float(loss)
    st.losses.append(value)
    return value


def unit(st, k):
    """Window step k (after the warm steps)."""
    st.window_losses.append(_step(st, len(st.losses)))


def release(st):
    """Drop the program's state; keep what the check reads."""
    for name in ("sc", "cam", "target", "params", "opt", "step"):
        setattr(st, name, None)


def failed_units(st):
    return sum(1 for v in st.window_losses if not np.isfinite(v))


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def _leaf_gaps(prog, ref, keep):
    """max over the kept leaves of | |prog_k| - |ref_k| | / max(|ref_k|,
    median |ref|)."""
    norms = {k: _norm(ref[k]) for k in keep}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    for k in keep:
        gap = abs(_norm(prog[k]) - norms[k])
        worst = max(worst, gap / max(norms[k], med, 1e-30))
    return worst


def readings(prog, ref, n):
    """The compared numbers: worst relative loss gap over the first n
    steps, worst first-gradient leaf gap, worst parameter-change leaf
    gap after n steps. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out: round-off alone moves
    them under Adam."""
    g = {k: _norm(v) for k, v in ref["grad1"].items()}
    med = float(np.median(list(g.values())))
    keep = [k for k in g if g[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"][:n], ref["loss"][:n]))
    if not all(np.isfinite(prog["loss"][:n])):
        loss_gap = float("inf")
    delta_p = {k: np.asarray(prog["params"][k], np.float64)
               - np.asarray(prog["init"][k], np.float64)
               for k in prog["init"]}
    delta_r = {k: np.asarray(ref["params"][k], np.float64)
               - np.asarray(ref["init"][k], np.float64)
               for k in ref["init"]}
    return {"loss_gap": loss_gap,
            "grad1_gap": _leaf_gaps(prog["grad1"], ref["grad1"], keep),
            "change_gap": _leaf_gaps(delta_p, delta_r, keep)}


def reference(st, w, device, dtype=torch.float32):
    """The reference's loss, first gradient and parameters over the warm
    steps, from the same scene dict, target, initial values and seed."""
    from perfbench.reference import tracer

    n = w["warm_steps"]
    out = tracer.train_steps(st.scene_d, st.cam_d,
                             torch.as_tensor(st.target_np), w, st.seed, n,
                             device, dtype, init=st.init)
    return {"loss": out["loss"],
            "grad1": {k: v.cpu().numpy() for k, v in out["grad1"].items()},
            "params": {k: v.cpu().numpy()
                       for k, v in out["params"][n - 1].items()},
            "init": st.init}


def program_answers(st, w):
    return {"loss": st.losses[:w["warm_steps"]], "grad1": st.grad1,
            "params": st.params_warm, "init": st.init}


def check(run, st):
    """-> {name: reading} of this run."""
    ref = reference(st, run.workload, run.device)
    return readings(program_answers(st, run.workload), ref,
                    run.workload["warm_steps"])


def control(run, st, dtype):
    """The same readings with the reference in ``dtype`` in the
    program's place."""
    w = run.workload
    return readings(reference(st, w, run.device, dtype),
                    reference(st, w, run.device), w["warm_steps"])
