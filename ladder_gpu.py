#!/usr/bin/env python3
"""The golden ladder's rungs 4 and 5 at their spec on one NVIDIA card,
through the port's own CLIs (``yhair_tpu_torch.apps.render`` and
``apps.invert``), written as the reference's ``benchmarks/run_ladder.py``
writes its goldens.

    python3 ladder_gpu.py [--dir goldens/torch] [--revision REV] [4] [5]

Rung 4 renders config 4 (512x512, 32 spp, depth 6, seed 0). Rung 5
renders config 5's target (1024x1024, 64 spp, depth 6, seed 0), then
runs the reference's inverse on it (``run_ladder.py:117-123``: 120
steps, lr 5e-2, 2,048-pixel batches, beta_m, beta_n and sigma_a from
1.8x the truth, seed 0). Into --dir:

  config{4,5}_stats.json   the render's stats (run_ladder.py's
                           ``_stats``), its seconds, the card
  config5_recovered.json   ``invert --out``: recovered and true values,
                           final loss and gradients, every step's loss
  config5_run.json         both argvs without their paths, the card,
                           the target's seconds, each step's seconds,
                           the revision
  config{4,5}_full.pfm/.png  the full-size images (git-ignored)
  config5_invert.ckpt      the inverse's checkpoint (git-ignored)

Each artifact's JSON is also printed on a line of its own. Both CLIs
checkpoint (the render every 8 samples, the inverse every 20 steps), so
a run cut short resumes where it stopped when started again with the
same --dir; a rung whose artifacts exist is skipped. The render takes
about 24 minutes for config 5 and the inverse a few seconds a step on
an H100, so a chip call with a time limit of an hour holds both. Needs
a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# run_ladder.py:117-123's argv without its paths (--target, --out and
# --checkpoint, which this script fills in)
INVERT5_ARGV = ["--config", "5", "--resolution", "1024", "--spp", "64",
                "--bounces", "6", "--steps", "120", "--lr", "5e-2",
                "--pixel-batch", "2048",
                "--params", "beta_m,beta_n,sigma_a"]
PATH_FLAGS = ("--output", "--hdr", "--checkpoint", "--target", "--out")


def emit(name, record):
    print(json.dumps({"artifact": name, **record}), flush=True)


def write_json(directory, name, record):
    with open(os.path.join(directory, name), "w") as f:
        json.dump(record, f, indent=1)
    emit(name, record)


def without_paths(argv):
    out, it = [], iter(argv)
    for a in it:
        if a in PATH_FLAGS:
            next(it)
        else:
            out.append(a)
    return out


def stats(img):
    """``benchmarks/run_ladder.py:_stats``."""
    import numpy as np
    lum = img.mean(axis=-1)
    return {
        "mean": float(img.mean()),
        "max": float(img.max()),
        "p50_lum": float(np.percentile(lum, 50)),
        "p99_lum": float(np.percentile(lum, 99)),
        "nonzero_frac": float((lum > 1e-6).mean()),
        "finite": bool(np.isfinite(img).all()),
    }


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def git_revision():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=ROOT).stdout.strip() or "unknown"
    except FileNotFoundError:
        return "unknown"


def render_rung(n, directory, card, revision):
    """``render --config n`` at its spec -> config{n}_stats.json."""
    import numpy as np

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.apps import render
    from yhair_tpu_torch.utils import checkpoint as ckpt

    out = os.path.join(directory, f"config{n}_stats.json")
    if os.path.exists(out):
        print(f"config {n}: {out} exists, skipped", flush=True)
        return
    base = os.path.join(directory, f"config{n}")
    ck = base + ".ckpt"
    argv = ["--config", str(n), "--output", base + "_full.png",
            "--hdr", base + "_full.pfm", "--checkpoint", ck]
    resumed = (ckpt.load_render_state(ck)["next_sample"]
               if os.path.exists(ck) else 0)
    print(f"== config {n}: render {' '.join(argv)}", flush=True)
    res = render.main(argv)
    cfg = CONFIGS[n]
    img = np.asarray(res["image"], np.float32)
    record = {
        "config": n, "res": cfg["res"], "spp": cfg["spp"],
        "depth": cfg["depth"], "seconds": res["render_s"],
        "resumed_from_sample": resumed,
        "mcam_rays_s": (cfg["res"] ** 2 * (cfg["spp"] - resumed)
                        / res["render_s"] / 1e6),
        "load_seconds": res["load_s"], "nvidia_smi": card,
        "revision": revision, "argv": without_paths(argv), **stats(img)}
    # the render is whole: its checkpoint (25 MB at 1024x1024) goes
    os.remove(ck)
    write_json(directory, f"config{n}_stats.json", record)


@contextlib.contextmanager
def step_seconds():
    """-> a list that gets the seconds of each ``mesh.train_step_fn``
    step taken within the ``with``, each ended by a device sync."""
    import torch

    from yhair_tpu_torch.parallel import mesh

    seconds, build = [], mesh.train_step_fn

    def timed_train_step_fn(*args, **kwargs):
        step = build(*args, **kwargs)

        def timed_step(*a, **kw):
            t0 = time.perf_counter()
            loss_grads = step(*a, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return loss_grads
        return timed_step

    mesh.train_step_fn = timed_train_step_fn
    try:
        yield seconds
    finally:
        mesh.train_step_fn = build


def invert_rung(directory, card, revision):
    """The reference's config-5 inverse on config5_full.pfm ->
    config5_recovered.json and config5_run.json."""
    from yhair_tpu_torch.apps import invert

    out = os.path.join(directory, "config5_recovered.json")
    if os.path.exists(out):
        print(f"config 5 inverse: {out} exists, skipped", flush=True)
        return
    argv = [*INVERT5_ARGV,
            "--target", os.path.join(directory, "config5_full.pfm"),
            "--out", out,
            "--checkpoint", os.path.join(directory, "config5_invert.ckpt")]
    with open(os.path.join(directory, "config5_stats.json")) as f:
        target = json.load(f)
    print(f"== config 5 inverse: {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    with step_seconds() as seconds:
        res = invert.main(argv)
    invert_s = time.perf_counter() - t0
    emit("config5_recovered.json", res)
    write_json(directory, "config5_run.json", {
        "render_argv": target["argv"], "invert_argv": without_paths(argv),
        "nvidia_smi": card, "target_seconds": target["seconds"],
        "target_resumed_from_sample": target["resumed_from_sample"],
        "steps": res["steps"], "steps_timed": len(seconds),
        "steps_seconds": sum(seconds), "step_seconds": seconds,
        "invert_seconds": invert_s, "revision": revision})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rungs", nargs="*", type=int, choices=(4, 5),
                   help="the rungs to run (default: 4 and 5)")
    p.add_argument("--dir", default=os.path.join(ROOT, "goldens", "torch"),
                   help="where the artifacts, images and checkpoints go")
    p.add_argument("--revision", default=None,
                   help="the code's revision, recorded in the artifacts "
                        "(default: git rev-parse --short HEAD)")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ladder_gpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    revision = args.revision or git_revision()
    card = nvidia_smi()
    print(card, flush=True)
    os.makedirs(args.dir, exist_ok=True)
    for n in args.rungs or (4, 5):
        render_rung(n, args.dir, card, revision)
        if n == 5:
            invert_rung(args.dir, card, revision)
    return 0


if __name__ == "__main__":
    sys.exit(main())
