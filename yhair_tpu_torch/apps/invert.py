"""Inverse-rendering CLI of the port (``yhair_tpu/apps/invert.py``):
recover hair parameters from a target image by gradient descent through
the differentiable renderer.

  python -m yhair_tpu_torch.apps.invert (--scene scene.json | --config 3) \\
      [--resolution 64] [--spp 4] [--steps 60] \\
      [--params beta_m,beta_n,sigma_a] [--target target.pfm] \\
      [--pixel-batch 4096] [--edge-softness 0.3] \\
      [--checkpoint invert.ckpt] [--tb-logdir runs/] [--profile-dir prof/] \\
      [--debug-nans] [--device cuda]

Without --target, the target image is rendered from the scene's true
parameters on the reference's uniforms for --seed, and the optimisation
starts from --init-scale times the true values (the synthetic-recovery
benchmark); the target renders with the same --edge-softness as the
steps, so soft silhouettes bias no parameter. Each step draws its
uniforms from its own seed word (``step_seed``) and, with
--pixel-batch, its tiles from a ``torch.Generator`` seeded with --seed;
neither is the reference's threefry stream. --checkpoint saves the
params, the optimizer, the step, that generator and the losses so far
every 20 steps and resumes from them, so a resumed run takes the steps
an uninterrupted one would. Writes the recovered and true values, the
last gradients and the loss of every step as JSON (from step 0, or from
the resumed step where the checkpoint holds no losses).

With --params ...,eumelanin,pheomelanin the true concentrations are the
least-squares fit of the scene's sigma_a over its three channels (exact
for a scene made from concentrations, as --config 4 is; a fit that
leaves more than 1e-4 of sigma_a is reported), and the JSON adds the
sigma_a the recovered concentrations imply (``sigma_a_implied``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import convert
from ..bsdf import hair as th
from ..io import image as img_io
from ..parallel import mesh
from ..utils import checkpoint as ckpt
from ..utils import trace
from .common import build_device_scene, load_scene, progressive_render

# a checkpoint is saved after every this many steps
CHECKPOINT_EVERY = 20
# the concentrations' fit to the scene's sigma_a is reported beyond this
# relative residual
MELANIN_FIT = 1e-4


def step_seed(seed: int, it: int) -> int:
    """Seed word of optimisation step ``it``: distinct from the target's
    (``key_seed(seed)``) and from every other step's."""
    return (mesh.key_seed(seed + 1) + 0x9E3779B1 * (it + 1)) & 0xFFFFFFFF


def concentrations(sigma_a):
    """Least-squares (eumelanin, pheomelanin) of sigma_a (..., 3) over
    its three channels, in float64 -> (ce, cp, the largest residual
    relative to its sigma_a's norm). Exact where sigma_a was made from
    concentrations."""
    a = np.stack([th.EUMELANIN, th.PHEOMELANIN], 1)
    s = np.asarray(sigma_a, np.float64)
    rows = s.reshape(-1, 3)
    x = np.linalg.lstsq(a, rows.T, rcond=None)[0]
    rel = np.linalg.norm(rows - (a @ x).T, axis=1) / np.maximum(
        np.linalg.norm(rows, axis=1), 1e-30)
    return (x[0].reshape(s.shape[:-1]), x[1].reshape(s.shape[:-1]),
            float(rel.max()))


def build_parser():
    p = argparse.ArgumentParser(prog="yhair-torch-invert",
                                description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON path")
    src.add_argument("--config", type=int, choices=range(1, 6),
                     help="builtin ladder config (scenes.generators.CONFIGS)")
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--params", default="beta_m,beta_n,sigma_a",
                   help="comma list of hair params to optimize; "
                        "eumelanin,pheomelanin (together, without sigma_a) "
                        "optimize the melanin concentrations that give "
                        "sigma_a")
    p.add_argument("--target", default=None,
                   help="target HDR image (.pfm/.exr/.hdr/.npy); default: "
                        "self-render")
    p.add_argument("--pixel-batch", type=int, default=None,
                   help="stochastic minibatch: pixels sampled per step "
                        "(whole 128-pixel tiles; default: full image)")
    p.add_argument("--edge-softness", type=float, default=0.0,
                   help="soft strand silhouettes: enables the boundary "
                        "term of geometry gradients (try 0.3)")
    p.add_argument("--init-scale", type=float, default=1.8,
                   help="multiplicative perturbation of the initial params")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="recovered_params.json")
    p.add_argument("--checkpoint", default=None,
                   help="training-state file: resumed from, saved to every "
                        f"{CHECKPOINT_EVERY} steps")
    p.add_argument("--tb-logdir", default=None,
                   help="write TensorBoard scalars (loss, grad norms, "
                        "param trajectories, it/s) to this directory")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the third to fifth "
                        "steps, with the program's spans, and their "
                        "counters (counters.json) into this directory")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first NaN-producing op "
                        "(utils/debug.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def load_target(path, res):
    img = img_io.load_hdr(path)
    if img.shape != (res, res, 3):
        raise SystemExit(f"target is {img.shape}, expected {(res, res, 3)}")
    return torch.as_tensor(np.asarray(img, np.float32))


def main(argv=None):
    """Run the optimisation; returns the result written to --out."""
    args = build_parser().parse_args(argv)
    if args.debug_nans:
        from ..utils.debug import enable_debug_nans
        enable_debug_nans()
    names = [s.strip() for s in args.params.split(",") if s.strip()]
    mesh.check_leaves(names)
    scene_d, cam_d = load_scene(args)
    sc, cam = build_device_scene(scene_d, cam_d, device=args.device)
    dev = sc.env.device
    res, spp, depth = args.resolution, args.spp, args.bounces

    if args.target:
        target = load_target(args.target, res).to(dev)
    else:
        target = torch.as_tensor(np.float32(progressive_render(
            sc, cam, res, res, spp, depth, seed=args.seed,
            edge_softness=args.edge_softness, log=None, device=dev)),
            device=dev)
        print("rendered synthetic target from true parameters")

    true_vals = {k: getattr(sc.hair, k).cpu().numpy() for k in names
                 if k not in mesh.MELANIN}
    if mesh.MELANIN[0] in names:
        # the scene's float64 sigma_a (rows of a per-shape table)
        ms = scene_d.get("hair_materials")
        sigma_a = np.asarray(np.stack([m["sigma_a"] for m in ms]) if ms
                             else scene_d["hair_material"]["sigma_a"])
        ce, cp, resid = concentrations(sigma_a)
        true_vals.update(eumelanin=ce, pheomelanin=cp)
        if resid > MELANIN_FIT:
            print(f"the scene's sigma_a {sigma_a.tolist()} is no melanin "
                  f"mix: the concentrations' fit leaves {resid:.3g} of it")
    params = convert.params_from_numpy(
        {k: true_vals[k] * args.init_scale for k in names}, device=dev)
    opt = torch.optim.Adam(params.values(), lr=args.lr)
    step = mesh.train_step_fn(res, res, spp, max_depth=depth,
                              pixel_batch=args.pixel_batch,
                              edge_softness=args.edge_softness, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    start, losses = 0, []
    if args.checkpoint and os.path.exists(args.checkpoint):
        start, seed, saved = ckpt.load_train_state(args.checkpoint, params,
                                                   opt, gen)
        if seed != args.seed:
            raise ValueError(f"{args.checkpoint} was trained with seed "
                             f"{seed}, not {args.seed}")
        losses = list(saved or [])
        print(f"resumed at step {start}")

    tb = None
    if args.tb_logdir:
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(args.tb_logdir)
    prof = None
    loss = grads = None
    t0 = time.time()
    for it in range(start, args.steps):
        if args.profile_dir and it == start + 2:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
            trace.reset()
            trace.enable()
            prof.start()
        loss, grads = step(params, opt, sc, cam, target,
                           step_seed(args.seed, it), generator=gen)
        losses.append(float(loss))
        if prof is not None and it == start + 4:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.stop()
            trace.disable()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "invert_trace.json")
            prof.export_chrome_trace(path)
            with open(os.path.join(args.profile_dir, "counters.json"),
                      "w") as f:
                json.dump(trace.counters(), f, indent=1)
            prof = None
            print(f"wrote profiler trace to {path}")
        if tb is not None:
            tb.add_scalar("loss", float(loss), it)
            tb.add_scalar("it_per_s", (it - start + 1) / (time.time() - t0),
                          it)
            for k, g in grads.items():
                tb.add_scalar(f"grad_norm/{k}", float(g.norm()), it)
            for k, v in params.items():
                for ci, vv in enumerate(v.detach().reshape(-1)[:3].tolist()):
                    tb.add_scalar(f"param/{k}/{ci}", vv, it)
        if it % 10 == 0 or it == args.steps - 1:
            vals = {k: v.tolist() for k, v in params.items()}
            print(f"step {it:4d} loss {float(loss):.6f} "
                  f"({(it - start + 1) / (time.time() - t0):.2f} it/s) "
                  f"{json.dumps(vals)}")
        if args.checkpoint and it % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1:
            ckpt.save_train_state(args.checkpoint, params, opt, it + 1,
                                  args.seed, gen, losses)
    if prof is not None:
        prof.stop()
        trace.disable()
    if tb is not None:
        tb.close()

    result = {
        "recovered": {k: v.tolist() for k, v in params.items()},
        "true": {k: true_vals[k].tolist() for k in names},
        "final_loss": None if loss is None else float(loss),
        "losses": losses,
        "final_grads": (None if grads is None
                        else {k: g.tolist() for k, g in grads.items()}),
        "steps": args.steps,
    }
    if mesh.MELANIN[0] in names:
        result["sigma_a_implied"] = th.sigma_a_from_concentration(
            params["eumelanin"], params["pheomelanin"]).detach().tolist()
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    for k in names:
        print(f"  {k}: true={true_vals[k]} "
              f"recovered={params[k].detach().cpu().numpy()}")
    return result


if __name__ == "__main__":
    main()
