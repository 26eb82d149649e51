#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``yhair_tpu_torch``) on one NVIDIA
card.

    python3 chip_smoke.py [--stop-after build|kernels|main] [--profile]

Phases, each printed as one JSON line; any failure exits non-zero:

1. build    nvcc builds ``yhair_tpu_torch/csrc/intersect.cu``; the card's
            name and power limit are printed as nvidia-smi gives them.
2. kernels  one 65,536-ray strip of the bench workload (the 10k-strand
            hairball, 512x512, depth 4) is traced with every kernel
            launch recorded: the camera rays and every bounce's rays.
            Each recorded launch is held against its plain PyTorch
            version (bit-equal), every nearest-hit search against the
            brute force on 1 ray in 16 (bit-equal winners), and every
            hit's t against the closed-form recompute (bit-equal).
            Kernel and plain times per launch are taken on these inputs.
            For each kind of launch (search and list capacity) it prints
            the mean and maximum list length and the kernels' work items.
            The any kernel's bound counts the visits a sequential walk
            needs until each block is dark (from any_pass_plain).
3. main     the bench workload through ``apps.render.progressive_render``
            (512x512, 1 spp, depth 4, four strips), with the launch
            counts set to 0 just before and read just after.
4. train    the training path. (a) bench.py's forward+backward: the
            bench frame as four strips, each ``L.mean().backward()`` into
            beta_m, beta_n and sigma_a leaves; one warm-up frame, then
            one timed frame with the launch counts set to 0 just before
            and read just after, and the peak device memory. (b) The
            gradient check: one 65,536-ray strip at depth 1, where no
            sampled direction is traced, so d L.mean() / d param must lie
            within 2% of a central finite difference of the port's own
            render for beta_m, beta_n and each sigma_a channel. (c) The
            ``invert`` CLI, three steps on the full hairball at 512x512
            with a 65,536-pixel batch: finite loss and gradients, every
            param inside PARAM_BOUNDS and moved from its start.
5. golden   ladder config 3 at its spec (256x256, 16 spp, depth 6, seed
            0) against ``goldens/config3_stats.json``.

With --profile, a last phase traces one bench strip with torch.profiler
and prints the device time of each layer: the cluster lists (torch ops),
the two kernels, and the rest (camera, shading, sort, bookkeeping); then
one forward+backward strip, with the backward's device time (the
autograd engine's functions) and the device's idle share.

The line before the last is the ``kernels`` record, the last one
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "goldens")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
FP32_PEAK = 67e12
HBM_BYTES_S = 3.35e12
# FP32 operations of one ray-segment test (csrc/intersect.cu's note)
FLOP_PER_TEST = 55
TESTS_PER_VISIT = 128 * 128
# the device kernels behind each counted launch (csrc/intersect.cu)
DEVICE_KERNELS = {"hit_kernel": ("hit_kernel", "hit_merge_kernel"),
                  "any_kernel": ("any_kernel",)}

WIDTH = HEIGHT = 512
SPP, DEPTH, STRIP = 1, 4, 65536
GOLDEN_MEAN_RTOL, GOLDEN_P99_RTOL = 0.01, 0.03
# bench.py differentiates with respect to these
TRAIN_PARAMS = ("beta_m", "beta_n", "sigma_a")
FD_EPS, FD_RTOL = 1e-3, 0.02


def emit(**fields):
    print(json.dumps(fields), flush=True)


def require(cond, phase, what):
    if not cond:
        emit(phase=phase, ok=False, error=what)
        sys.exit(1)


class Recorder:
    """Wraps the kernel wrappers and the two-pass nearest search of
    ``ops.intersect_kernel`` for the span of a ``with``, keeping every
    call's inputs and outputs. Launches still go through the wrappers."""

    def __init__(self, ik):
        self.ik = ik
        self.hit, self.any, self.nearest = [], [], []

    def __enter__(self):
        import torch
        ik = self.ik
        self.orig = (ik.hit_pass, ik.any_pass, ik.nearest_hit)
        hit_pass, any_pass, nearest_hit = self.orig

        def rec_hit(o, d, seeds, ids, counts, tc, k_cap):
            out = hit_pass(o, d, seeds, ids, counts, tc, k_cap)
            self.hit.append(((o, d, seeds, ids, counts, tc, k_cap), out))
            return out

        def rec_any(o, d, t_cap, ids, counts, tc, k_cap):
            visits = torch.empty(counts.shape, dtype=torch.int32,
                                 device=o.device)
            out = any_pass(o, d, t_cap, ids, counts, tc, k_cap,
                           visits=visits)
            self.any.append(((o, d, t_cap, ids, counts, tc, k_cap), out,
                             visits))
            return out

        def rec_nearest(o, d, cl):
            out = nearest_hit(o, d, cl)
            self.nearest.append((o, d, out))
            return out

        ik.hit_pass, ik.any_pass, ik.nearest_hit = (rec_hit, rec_any,
                                                    rec_nearest)
        return self

    def __exit__(self, *exc):
        self.ik.hit_pass, self.ik.any_pass, self.ik.nearest_hit = self.orig


def timed(fn, reps=1):
    """(last result, mean device ms) of reps calls of fn on the current
    stream, between two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def bound_ms(visits, n_bytes):
    """(ops ms, bytes ms): visits x 128^2 tests over the FP32 peak, and
    each input read once and each output written once over HBM's rate."""
    return (visits * TESTS_PER_VISIT * FLOP_PER_TEST / FP32_PEAK * 1e3,
            n_bytes / HBM_BYTES_S * 1e3)


def new_stats(launches):
    return dict(launches=launches, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0)


def add_bound(st, ops_ms, bytes_ms):
    st["bound_ms"] += max(ops_ms, bytes_ms)
    st["ops_ms"] += ops_ms
    st["bytes_ms"] += bytes_ms


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_lines(log):
    """nvcc -Xptxas -v: each kernel's name, registers, shared memory and
    spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry function" in ln]


def phase_build():
    from yhair_tpu_torch.ops import _cuda
    t0 = time.time()
    lib, log = _cuda.build()
    _cuda.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="build", ok=True, seconds=time.time() - t0,
         library=os.path.relpath(lib, ROOT),
         ptxas=ptxas_lines(log),
         nvidia_smi=smi)
    return smi


def list_stats(kinds, key, counts_p):
    """Per kind of launch: list lengths (the sentinel counts C, the
    visits it makes) and work items."""
    from yhair_tpu_torch.ops import intersect_kernel as ik
    st = kinds.setdefault(key, dict(launches=0, blocks=0, visits=0,
                                    max_list=0, work_items=0))
    st["launches"] += 1
    st["blocks"] += counts_p.numel()
    st["visits"] += int(counts_p.sum())
    st["max_list"] = max(st["max_list"], int(counts_p.max()))
    st["work_items"] += int(ik._work_items(counts_p, ik.CHUNK)[-1])
    return st


def summarize_kinds(kinds):
    return {k: dict(launches=v["launches"],
                    mean_list=v["visits"] / max(v["blocks"], 1),
                    max_list=v["max_list"],
                    work_items_per_launch=v["work_items"] / v["launches"],
                    **{f: v[f] for f in ("needed_visits", "kernel_visits")
                       if f in v})
            for k, v in sorted(kinds.items())}


def phase_kernels(sc, cam, dev):
    """Every launch of one bench strip against its plain version."""
    import torch

    from yhair_tpu_torch.geometry import segments as seg
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    cl = sc.accel
    c = cl.n_clusters
    perm, _ = mesh.tile_pixel_permutation(WIDTH, HEIGHT)
    pid = torch.as_tensor(perm[:STRIP], device=dev)
    with Recorder(ik) as rec:
        img = mesh.trace_pixels(sc, cam, WIDTH, HEIGHT, pid,
                                torch.zeros_like(pid), mesh.key_seed(0),
                                DEPTH, device=dev)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(img).all()), "kernels", "strip not finite")
    kinds = {}

    hit_stats = new_stats(len(rec.hit))
    for args, out in rec.hit:
        o, d, seeds, ids, counts, tc, k_cap = args
        ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, c)
        list_stats(kinds, f"hit k_cap={k_cap}", counts_p)
        plain, ms_plain = timed(lambda: ik.hit_pass_plain(
            o, d, seeds, ids_p, counts_p, tc, k_cap))
        for name, a, b in zip(("t", "idx", "oid"), out, plain):
            require(torch.equal(a, b), "kernels",
                    f"hit kernel {name} differs from hit_pass_plain "
                    f"({int((a != b).sum())} rays)")
        hit_stats["max_abs_err"] = max(
            hit_stats["max_abs_err"],
            float((out[0] - plain[0]).abs().max()))
        _, ms = timed(lambda: ik.hit_pass(*args), 5)
        add_bound(hit_stats, *bound_ms(
            int(counts_p.sum()),
            nbytes(o, d, *seeds, ids_p, counts_p, tc, *out)))
        hit_stats["ms"] += ms
        hit_stats["plain_ms"] += ms_plain

    any_stats = new_stats(len(rec.any))
    for args, out, visits in rec.any:
        o, d, t_cap, ids, counts, tc, k_cap = args
        ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, c)
        st = list_stats(kinds, f"any k_cap={k_cap}", counts_p)
        (plain, need), ms_plain = timed(lambda: ik.any_pass_plain(
            o, d, t_cap, ids_p, counts_p, tc, k_cap, return_visits=True))
        require(torch.equal(out, plain), "kernels",
                f"any kernel differs from any_pass_plain "
                f"({int((out != plain).sum())} rays)")
        # the bound counts what a sequential front-to-back walk needs,
        # whatever extra work the kernel's parallel items did
        st["needed_visits"] = st.get("needed_visits", 0) + int(need.sum())
        st["kernel_visits"] = st.get("kernel_visits", 0) + int(visits.sum())
        _, ms = timed(lambda: ik.any_pass(*args), 5)
        add_bound(any_stats, *bound_ms(
            int(need.sum()),
            nbytes(o, d, t_cap, ids_p, counts_p, tc, out)))
        any_stats["ms"] += ms
        any_stats["plain_ms"] += ms_plain

    # the two-pass searches against the brute force, and each hit's t
    # against the integrator's closed-form recompute
    segs = sc.segments
    n_brute = n_hits = 0
    for o, d, (t, idx, hit) in rec.nearest:
        sub = slice(None, None, 16)
        tb, ib, hb = seg.nearest_hit(o[sub], d[sub], segs,
                                     ids=cl.seg_index)
        require(torch.equal(hb, hit[sub])
                and torch.equal(tb[hb], t[sub][hb])
                and torch.equal(ib[hb], idx[sub][hb]), "kernels",
                "two-pass kernel search differs from the brute force")
        n_brute += int(o[sub].shape[0])
        h = idx[hit].long()
        s_re, _, _ = seg._closest_approach(o[hit], d[hit], segs.p0[h],
                                           segs.p1[h])
        require(torch.equal(s_re, t[hit]), "kernels",
                f"kernel t differs from the recompute on "
                f"{int((s_re != t[hit]).sum())} of {int(hit.sum())} hits")
        n_hits += int(hit.sum())

    for st in (hit_stats, any_stats):
        n = max(st["launches"], 1)
        for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
            st[k] /= n
        st["bound_by"] = ("operations" if st["ops_ms"] >= st["bytes_ms"]
                          else "bytes")
    emit(phase="kernels", ok=True, strip_rays=STRIP, depth=DEPTH,
         hit_launches=hit_stats["launches"],
         any_launches=any_stats["launches"], nearest_searches=len(
             rec.nearest), brute_force_rays=n_brute, recomputed_hits=n_hits,
         kernel_vs_plain="bit-equal", brute_force="bit-equal winners",
         recompute="bit-equal t", chunk=ik.CHUNK,
         per_launch_ms={k: {f: st[f] for f in ("ms", "plain_ms", "ops_ms",
                                              "bytes_ms")}
                        for k, st in (("hit", hit_stats),
                                      ("any", any_stats))},
         lists=summarize_kinds(kinds))
    return hit_stats, any_stats


def phase_main(sc, cam, dev):
    import numpy as np
    import torch

    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.ops import intersect_kernel as ik

    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, (n_alive, n_shadow) = app.progressive_render(
        sc, cam, WIDTH, HEIGHT, SPP, DEPTH, seed=0, return_alive=True,
        log=None, device=dev)
    frame_s = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES)
    require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()),
            "main", "image not finite or of the wrong shape")
    require(all(n > 0 for n in launches.values()), "main",
            f"a kernel was not launched on the main path: {launches}")
    n_rays = WIDTH * HEIGHT * SPP
    rays = n_rays * DEPTH * (1 + sc.n_lights)
    emit(phase="main", ok=True, width=WIDTH, height=HEIGHT, spp=SPP,
         depth=DEPTH, strips=-(-n_rays // STRIP), frame_s=frame_s,
         mrays_s=rays / frame_s / 1e6,
         alive_frac=(n_alive + n_shadow) / rays,
         alive_bounce_rays=n_alive, live_shadow_rays=n_shadow,
         launches=launches, image_mean=float(img.mean()))
    return launches


def trainable(sc):
    """(scene with fresh leaves for TRAIN_PARAMS, the leaves)."""
    from yhair_tpu_torch import convert

    params = convert.params_from_numpy(
        {k: getattr(sc.hair, k).cpu().numpy() for k in TRAIN_PARAMS},
        device=sc.env.device)
    return sc._replace(hair=sc.hair._replace(**params)), params


def bench_fwdbwd(sc, cam, dev):
    """bench.py's forward+backward: a warm-up frame, then a timed one."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    scp, params = trainable(sc)
    perm, _ = mesh.tile_pixel_permutation(WIDTH, HEIGHT)
    pid_all = torch.as_tensor(perm, device=dev)
    n_rays = WIDTH * HEIGHT * SPP

    def frame():
        for b in range(-(-n_rays // STRIP)):
            pid = pid_all[b * STRIP:(b + 1) * STRIP]
            L = mesh.trace_pixels(scp, cam, WIDTH, HEIGHT, pid,
                                  torch.zeros_like(pid), mesh.key_seed(0),
                                  DEPTH, device=dev)
            L.mean().backward()

    frame()
    for p in params.values():
        p.grad = None
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame()
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES)
    grads = {k: p.grad.cpu() for k, p in params.items()}
    require(all(n > 0 for n in launches.values()), "train",
            f"a kernel was not launched in the forward+backward frame: "
            f"{launches}")
    require(all(bool(torch.isfinite(g).all() and (g != 0).all())
                for g in grads.values()), "train",
            f"forward+backward gradients not finite and non-zero: {grads}")
    rays = n_rays * DEPTH * (1 + sc.n_lights)
    return dict(fwdbwd_frame_s=frame_s, fwdbwd_mrays_s=rays / frame_s / 1e6,
                fwdbwd_launches=launches,
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                fwdbwd_grads={k: g.tolist() for k, g in grads.items()})


def gradient_check(sc, cam, dev, width=WIDTH, height=HEIGHT,
                   n_rays=STRIP):
    """Depth-1 d L.mean() / d param against central finite differences of
    the port's own render, on the uniforms of the first n_rays rays of
    the tile order (``tests/test_torch_kernels_cuda.py`` calls it on a
    small hairball)."""
    import torch

    from yhair_tpu_torch.parallel import mesh

    perm, _ = mesh.tile_pixel_permutation(width, height)
    pid = torch.as_tensor(perm[:n_rays], device=dev)

    def loss(scene):
        L = mesh.trace_pixels(scene, cam, width, height, pid,
                              torch.zeros_like(pid), mesh.key_seed(0), 1,
                              device=dev)
        return L.double().mean()

    scp, params = trainable(sc)
    loss(scp).backward()
    pairs = []
    with torch.no_grad():
        for k, p in params.items():
            for c in range(p.numel()):
                def at(delta):
                    v = p.detach().clone()
                    v.view(-1)[c] += delta
                    s = sc._replace(hair=sc.hair._replace(**{k: v}))
                    return float(loss(s)), float(v.view(-1)[c])
                (lp, xp), (lm, xm) = at(FD_EPS), at(-FD_EPS)
                fd = (lp - lm) / (xp - xm)
                g = float(p.grad.view(-1)[c])
                rel = abs(g - fd) / max(abs(fd), 1e-30)
                pairs.append(dict(param=k if p.numel() == 1 else f"{k}[{c}]",
                                  autograd=g, finite_difference=fd,
                                  rel_err=rel))
                require(fd != 0.0 and rel <= FD_RTOL, "train",
                        f"gradient check failed: {pairs[-1]}")
    return pairs


def invert_steps(dev):
    """Three steps of the invert CLI on the full hairball."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from yhair_tpu_torch.apps import invert
    from yhair_tpu_torch.parallel import mesh

    log = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(log):
        res = invert.main(["--config", "3", "--resolution", str(WIDTH),
                           "--spp", str(SPP), "--bounces", str(DEPTH),
                           "--steps", "3", "--pixel-batch", str(STRIP),
                           "--out", os.path.join(tmp, "recovered.json"),
                           "--device", str(dev)])
    seconds = time.perf_counter() - t0
    require(bool(np.isfinite(res["final_loss"])), "train",
            f"invert loss not finite: {res['final_loss']}")
    for k, v in res["recovered"].items():
        v, g = np.asarray(v), np.asarray(res["final_grads"][k])
        start = np.float32(np.asarray(res["true"][k]) * 1.8)
        lo, hi = mesh.PARAM_BOUNDS[k]
        require(bool(np.isfinite(g).all() and (g != 0).all()), "train",
                f"invert gradient of {k} not finite and non-zero: {g}")
        require(bool(((v >= lo) & (v <= hi)).all()), "train",
                f"invert left {k} outside {(lo, hi)}: {v}")
        require(bool((v != start).all()), "train",
                f"invert did not move {k} from {start}")
    return dict(invert_seconds=seconds, invert_final_loss=res["final_loss"],
                invert_recovered=res["recovered"], invert_true=res["true"],
                invert_log=log.getvalue().splitlines())


def phase_train(sc, cam, dev):
    fields = bench_fwdbwd(sc, cam, dev)
    fields["gradient_check"] = gradient_check(sc, cam, dev)
    fields.update(invert_steps(dev))
    emit(phase="train", ok=True, width=WIDTH, height=HEIGHT, spp=SPP,
         depth=DEPTH, strips=-(-WIDTH * HEIGHT * SPP // STRIP),
         fd_eps=FD_EPS, fd_rtol=FD_RTOL, **fields)


def phase_golden(sc, cam, dev):
    import numpy as np

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.apps import render as app

    cfg = CONFIGS[3]
    with open(os.path.join(GOLDEN, "config3_stats.json")) as f:
        gold = json.load(f)
    ref = app.load_pfm(os.path.join(GOLDEN, "config3.pfm"))
    t0 = time.perf_counter()
    img = app.progressive_render(sc, cam, cfg["res"], cfg["res"],
                                 cfg["spp"], cfg["depth"], seed=0, log=None,
                                 device=dev)
    seconds = time.perf_counter() - t0
    lum = img.mean(-1)
    mean, p99 = float(img.mean()), float(np.percentile(lum, 99))
    mean_rel = abs(mean - gold["mean"]) / gold["mean"]
    p99_rel = abs(p99 - gold["p99_lum"]) / gold["p99_lum"]
    ok = (bool(np.isfinite(img).all()) and mean_rel <= GOLDEN_MEAN_RTOL
          and p99_rel <= GOLDEN_P99_RTOL)
    fields = dict(phase="golden", ok=ok, config=3, res=cfg["res"],
                  spp=cfg["spp"], depth=cfg["depth"], seconds=seconds,
                  mean=mean, golden_mean=gold["mean"], mean_rel=mean_rel,
                  mean_rtol=GOLDEN_MEAN_RTOL, p99_lum=p99,
                  golden_p99_lum=gold["p99_lum"], p99_rel=p99_rel,
                  p99_rtol=GOLDEN_P99_RTOL,
                  pixel_mean_abs_diff=float(np.abs(img - ref).mean()))
    require(ok, "golden", json.dumps(fields))
    emit(**fields)


def phase_profile(sc, cam, dev, top=12):
    """Device time per layer over one bench strip (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    perm, _ = mesh.tile_pixel_permutation(WIDTH, HEIGHT)
    pid = torch.as_tensor(perm[:STRIP], device=dev)

    def strip():
        mesh.trace_pixels(sc, cam, WIDTH, HEIGHT, pid, torch.zeros_like(pid),
                          mesh.key_seed(0), DEPTH, device=dev)
        torch.cuda.synchronize()

    def labelled(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    # the list build is torch ops under a labelled range; the kernels are
    # launched through ctypes, which the profiler does not tie to a
    # range, so they are found by their own names
    layers = {"layer:cluster_lists": "_block_cluster_lists"}
    orig = {name: getattr(ik, name) for name in layers.values()}
    strip()
    t0 = time.perf_counter()
    strip()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for label, name in layers.items():
        setattr(ik, name, labelled(label, orig[name]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            strip()
    finally:
        for name, fn in orig.items():
            setattr(ik, name, fn)
    avg = prof.key_averages()
    # device kernels only: the CPU ops and the annotation ranges repeat
    # the device time of the kernels under them
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("layer:")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_layer = {e.key[len("layer:"):]: e.device_time_total / 1e3
                for e in avg if e.key in layers
                and e.device_type == DeviceType.CPU}
    for name, parts in DEVICE_KERNELS.items():
        by_layer[name] = sum(e.self_device_time_total for e in kernels
                             if any(f"::{k}(" in e.key for k in parts)) / 1e3
    by_layer["rest"] = device_ms - sum(by_layer.values())
    kernels.sort(key=lambda e: -e.self_device_time_total)
    emit(phase="profile", ok=device_ms > 0, strip_rays=STRIP, depth=DEPTH,
         wall_ms=wall_ms, device_ms=device_ms,
         device_idle_frac=1.0 - device_ms / wall_ms, layer_ms=by_layer,
         top_device_kernels=[{"name": e.key[:90], "calls": e.count,
                              "ms": e.self_device_time_total / 1e3}
                             for e in kernels[:top]])
    require(device_ms > 0, "profile", "the profiler saw no device time")

    # one forward+backward strip: the backward is every function the
    # autograd engine evaluates
    scp, _ = trainable(sc)

    def train_strip():
        mesh.trace_pixels(scp, cam, WIDTH, HEIGHT, pid, torch.zeros_like(pid),
                          mesh.key_seed(0), DEPTH, device=dev).mean().backward()
        torch.cuda.synchronize()

    train_strip()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_strip()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_strip()
    avg = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA) / 1e3
    backward_ms = sum(e.device_time_total for e in avg
                      if e.device_type == DeviceType.CPU and e.key.startswith(
                          "autograd::engine::evaluate_function:")) / 1e3
    emit(phase="profile_fwdbwd", ok=device_ms > 0, strip_rays=STRIP,
         depth=DEPTH, wall_ms=wall_ms, device_ms=device_ms,
         backward_device_ms=backward_ms,
         forward_device_ms=device_ms - backward_ms,
         device_idle_frac=1.0 - device_ms / wall_ms,
         peak_device_bytes=peak,
         autograd_functions=sum(
             e.count for e in avg if e.device_type == DeviceType.CPU
             and e.key.startswith("autograd::engine::evaluate_function:")))
    require(device_ms > 0 and backward_ms > 0, "profile_fwdbwd",
            "the profiler saw no backward device time")


def kernel_record(name, replaces, st, launches):
    return {"name": name, "route": "cuda",
            "source": "yhair_tpu_torch/csrc/intersect.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stop-after", choices=("build", "kernels", "main"),
                   help="end after this phase, printing no result")
    p.add_argument("--profile", action="store_true",
                   help="also trace one bench strip with torch.profiler")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "yhair_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    phase_build()
    if args.stop_after == "build":
        return 0

    from yhair_tpu_torch.apps import render as app
    dev = torch.device("cuda")
    t0 = time.time()
    sc, cam, _, _, _ = app.load_config(3, device=dev)
    emit(phase="scene", ok=True, segments=int(sc.segments.p0.shape[0]),
         clusters=sc.accel.n_clusters, lights=sc.n_lights,
         seconds=time.time() - t0)
    hit_stats, any_stats = phase_kernels(sc, cam, dev)
    if args.stop_after == "kernels":
        return 0
    launches = phase_main(sc, cam, dev)
    if args.stop_after == "main":
        return 0
    phase_train(sc, cam, dev)
    phase_golden(sc, cam, dev)
    if args.profile:
        phase_profile(sc, cam, dev)

    print(json.dumps({"kernels": [
        kernel_record("hit_kernel",
                      "yhair_tpu/ops/intersect_kernel.py:186",
                      hit_stats, launches["hit_kernel"]),
        kernel_record("any_kernel",
                      "yhair_tpu/ops/intersect_kernel.py:316",
                      any_stats, launches["any_kernel"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
