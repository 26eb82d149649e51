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
6. scene5   ladder config 5 (the furry bunny) at full size: 300,000 hair
            segments in 4,096 clusters (a power of two; 2,344 hold
            segments), an 800-triangle mesh, a plane, a point light and
            a 64x128 environment map.
7. kernels5 as ``kernels``, on the 65,536-ray strip through the centre
            of config 5's 1024x1024 frame at depth 6: every launch
            bit-equal to its plain version, with the count of blocks
            sent as the "scan every cluster" sentinel (lists longer
            than MAX_IDS).
8. main5    config 5's frame (1024x1024, 1 spp, depth 6, 16 strips)
            through ``progressive_render``, launch counts set to 0 just
            before and read just after.
9. train5   config 5's forward+backward frame (timed once: main5 warmed
            the forward) and its peak memory; the card-against-CPU
            gradient check (a 32x32 window at the centre, depth 2, the
            card's gradients within GRAD5_RTOL of the CPU's plain
            kernels on the same rays); ``invert --config 5 --resolution
            1024 --spp 1 --bounces 6 --steps 3 --pixel-batch 2048``.
10. golden5 config 5 at 1024x1024, depth 6, on the first 4 of the
            golden's 64 sample streams: the mean within 1% of
            ``goldens/config5_stats.json``; the p99 and the 256x256
            box-downsample's mean |diff| from ``goldens/config5.pfm``
            are printed.

With --profile, a last phase traces one bench strip with torch.profiler
and prints the device time of each layer: the cluster lists (torch ops),
the triangle search (torch ops), the two kernels, and the rest (camera,
shading, sort, bookkeeping); then one forward+backward strip, with the
backward's device time (the autograd engine's functions) and the
device's idle share; then config 5's centre strip forward (``profile5``).

A ``total`` line gives the script's seconds.
The line before the last is the ``kernels`` record (each kernel on the
config-3 and on the config-5 path), the last one
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
# config 5 (the furry bunny under an environment map) at its golden's
# resolution and depth
W5 = H5 = 1024
DEPTH5 = 6
GOLDEN5_SPP = 4
INVERT5_BATCH = 2048
GRAD5_WINDOW, GRAD5_DEPTH, GRAD5_RTOL = 32, 2, 1e-2


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


def list_stats(kinds, key, counts_p, k_cap):
    """Per kind of launch: list lengths (the sentinel counts C, the
    visits it makes), work items and sentinel blocks (lists longer than
    k_cap, sent as "scan every cluster")."""
    from yhair_tpu_torch.ops import intersect_kernel as ik
    st = kinds.setdefault(key, dict(launches=0, blocks=0, visits=0,
                                    max_list=0, work_items=0,
                                    sentinel_blocks=0))
    st["launches"] += 1
    st["blocks"] += counts_p.numel()
    st["sentinel_blocks"] += int((counts_p > k_cap).sum())
    st["visits"] += int(counts_p.sum())
    st["max_list"] = max(st["max_list"], int(counts_p.max()))
    st["work_items"] += int(ik._work_items(counts_p, ik.CHUNK)[-1])
    return st


def summarize_kinds(kinds):
    return {k: dict(launches=v["launches"],
                    mean_list=v["visits"] / max(v["blocks"], 1),
                    max_list=v["max_list"],
                    work_items_per_launch=v["work_items"] / v["launches"],
                    sentinel_blocks=v["sentinel_blocks"],
                    **{f: v[f] for f in ("needed_visits", "kernel_visits")
                       if f in v})
            for k, v in sorted(kinds.items())}


def strip_pixels(width, height, index, dev):
    """Pixel ids of strip ``index`` of the tile order (STRIP pixels)."""
    import torch

    from yhair_tpu_torch.parallel import mesh

    perm, _ = mesh.tile_pixel_permutation(width, height)
    return torch.as_tensor(perm[index * STRIP:(index + 1) * STRIP],
                           device=dev)


def sentinel_check(rec, c, phase, n_blocks=4):
    """The "scan every cluster" sentinel at C > MAX_IDS: the first
    n_blocks blocks of the strip's last full-capacity hit and any
    launches again, block 0's list made longer than k_cap (every
    cluster), each held bit-equal against its plain version. -> per
    kernel: blocks sent as the sentinel, ms and plain ms."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik

    k_cap, rays = ik._k_cap(c), slice(0, n_blocks * ik.BLOCK)
    out = {}
    for kind, calls, run, plain in (
            ("hit", rec.hit, ik.hit_pass, ik.hit_pass_plain),
            ("any", rec.any, ik.any_pass, ik.any_pass_plain)):
        o, d, x, ids, counts, tc, _ = next(
            args for args, *_ in reversed(calls) if args[-1] == k_cap)
        x = tuple(v[rays] for v in x) if kind == "hit" else x[rays]
        counts = counts[:n_blocks].clone()
        counts[0] = c
        args = (o[rays], d[rays], x, ids[:n_blocks], counts, tc, k_cap)
        got, ms = timed(lambda: run(*args))
        ids_p, counts_p = ik._pack_lists(ids[:n_blocks], counts, k_cap, c)
        want, ms_plain = timed(lambda: plain(*args[:3], ids_p, counts_p, tc,
                                             k_cap))
        got, want = ((got,), (want,)) if kind == "any" else (got, want)
        require(all(torch.equal(a, b) for a, b in zip(got, want)), phase,
                f"{kind} kernel differs from its plain version on a "
                f"sentinel block")
        out[kind] = dict(sentinel_blocks=int((counts_p > k_cap).sum()),
                         rays=n_blocks * ik.BLOCK, ms=ms, plain_ms=ms_plain,
                         kernel_vs_plain="bit-equal")
    return out


def phase_kernels(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
                  strip=0, phase="kernels"):
    """Every launch of one strip against its plain version."""
    import torch

    from yhair_tpu_torch.geometry import segments as seg
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    cl = sc.accel
    c = cl.n_clusters
    pid = strip_pixels(width, height, strip, dev)
    with Recorder(ik) as rec:
        img = mesh.trace_pixels(sc, cam, width, height, pid,
                                torch.zeros_like(pid), mesh.key_seed(0),
                                depth, device=dev)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(img).all()), phase, "strip not finite")
    kinds = {}

    hit_stats = new_stats(len(rec.hit))
    for args, out in rec.hit:
        o, d, seeds, ids, counts, tc, k_cap = args
        ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, c)
        list_stats(kinds, f"hit k_cap={k_cap}", counts_p, k_cap)
        plain, ms_plain = timed(lambda: ik.hit_pass_plain(
            o, d, seeds, ids_p, counts_p, tc, k_cap))
        for name, a, b in zip(("t", "idx", "oid"), out, plain):
            require(torch.equal(a, b), phase,
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
        st = list_stats(kinds, f"any k_cap={k_cap}", counts_p, k_cap)
        (plain, need), ms_plain = timed(lambda: ik.any_pass_plain(
            o, d, t_cap, ids_p, counts_p, tc, k_cap, return_visits=True))
        require(torch.equal(out, plain), phase,
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

    sentinel = sentinel_check(rec, c, phase) if c > ik._k_cap(c) else None

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
                and torch.equal(ib[hb], idx[sub][hb]), phase,
                "two-pass kernel search differs from the brute force")
        n_brute += int(o[sub].shape[0])
        h = idx[hit].long()
        s_re, _, _ = seg._closest_approach(o[hit], d[hit], segs.p0[h],
                                           segs.p1[h])
        require(torch.equal(s_re, t[hit]), phase,
                f"kernel t differs from the recompute on "
                f"{int((s_re != t[hit]).sum())} of {int(hit.sum())} hits")
        n_hits += int(hit.sum())

    for st in (hit_stats, any_stats):
        n = max(st["launches"], 1)
        for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
            st[k] /= n
        st["bound_by"] = ("operations" if st["ops_ms"] >= st["bytes_ms"]
                          else "bytes")
    emit(phase=phase, ok=True, strip_rays=STRIP, depth=depth,
         strip_index=strip, hit_launches=hit_stats["launches"],
         any_launches=any_stats["launches"], nearest_searches=len(
             rec.nearest), brute_force_rays=n_brute, recomputed_hits=n_hits,
         kernel_vs_plain="bit-equal", brute_force="bit-equal winners",
         recompute="bit-equal t", chunk=ik.CHUNK, clusters=c,
         k_cap=ik._k_cap(c),
         sentinel_blocks=sum(v["sentinel_blocks"] for v in kinds.values()),
         sentinel_check=sentinel,
         per_launch_ms={k: {f: st[f] for f in ("ms", "plain_ms", "bound_ms",
                                              "ops_ms", "bytes_ms")}
                        for k, st in (("hit", hit_stats),
                                      ("any", any_stats))},
         lists=summarize_kinds(kinds))
    return hit_stats, any_stats


def shadow_rays_per_bounce(sc):
    """Shadow rays the integrator casts for each live bounce ray: one per
    point light, one for the environment map, one for the area lights."""
    from yhair_tpu_torch.core.envmap import has_env
    return sc.n_lights + int(has_env(sc)) + int(sc.n_area_lights > 0)


def phase_main(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
               phase="main"):
    import numpy as np
    import torch

    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.ops import intersect_kernel as ik

    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, (n_alive, n_shadow) = app.progressive_render(
        sc, cam, width, height, SPP, depth, seed=0, return_alive=True,
        log=None, device=dev)
    frame_s = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES)
    require(img.shape == (height, width, 3) and bool(np.isfinite(img).all()),
            phase, "image not finite or of the wrong shape")
    require(all(n > 0 for n in launches.values()), phase,
            f"a kernel was not launched on the main path: {launches}")
    n_rays = width * height * SPP
    rays = n_rays * depth * (1 + shadow_rays_per_bounce(sc))
    emit(phase=phase, ok=True, width=width, height=height, spp=SPP,
         depth=depth, strips=-(-n_rays // STRIP), frame_s=frame_s,
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


def bench_fwdbwd(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
                 warm_up=True, phase="train"):
    """bench.py's forward+backward: a warm-up frame, then a timed one."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    scp, params = trainable(sc)
    perm, _ = mesh.tile_pixel_permutation(width, height)
    pid_all = torch.as_tensor(perm, device=dev)
    n_rays = width * height * SPP

    def frame():
        for b in range(-(-n_rays // STRIP)):
            pid = pid_all[b * STRIP:(b + 1) * STRIP]
            L = mesh.trace_pixels(scp, cam, width, height, pid,
                                  torch.zeros_like(pid), mesh.key_seed(0),
                                  depth, device=dev)
            L.mean().backward()

    if warm_up:
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
    require(all(n > 0 for n in launches.values()), phase,
            f"a kernel was not launched in the forward+backward frame: "
            f"{launches}")
    require(all(bool(torch.isfinite(g).all() and (g != 0).all())
                for g in grads.values()), phase,
            f"forward+backward gradients not finite and non-zero: {grads}")
    rays = n_rays * depth * (1 + shadow_rays_per_bounce(sc))
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


def invert_steps(dev, argv=("--config", "3", "--resolution", str(WIDTH),
                             "--spp", str(SPP), "--bounces", str(DEPTH),
                             "--steps", "3", "--pixel-batch", str(STRIP)),
                 phase="train"):
    """Three steps of the invert CLI (by default on the full hairball)."""
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
        res = invert.main([*argv,
                           "--out", os.path.join(tmp, "recovered.json"),
                           "--device", str(dev)])
    seconds = time.perf_counter() - t0
    require(bool(np.isfinite(res["final_loss"])), phase,
            f"invert loss not finite: {res['final_loss']}")
    for k, v in res["recovered"].items():
        v, g = np.asarray(v), np.asarray(res["final_grads"][k])
        start = np.float32(np.asarray(res["true"][k]) * 1.8)
        lo, hi = mesh.PARAM_BOUNDS[k]
        require(bool(np.isfinite(g).all() and (g != 0).all()), phase,
                f"invert gradient of {k} not finite and non-zero: {g}")
        require(bool(((v >= lo) & (v <= hi)).all()), phase,
                f"invert left {k} outside {(lo, hi)}: {v}")
        require(bool((v != start).all()), phase,
                f"invert did not move {k} from {start}")
    return dict(invert_argv=list(argv), invert_seconds=seconds,
                invert_final_loss=res["final_loss"],
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


def centre_pixels(width, height, window):
    """Row-major pixel ids of the window x window block at the image
    centre (numpy int64)."""
    import numpy as np
    y0, x0 = (height - window) // 2, (width - window) // 2
    jj, ii = np.mgrid[y0:y0 + window, x0:x0 + window]
    return (jj * width + ii).reshape(-1)


def device_gradient_check(sc, cam, dev, width=W5, height=H5,
                          window=GRAD5_WINDOW, depth=GRAD5_DEPTH,
                          rtol=GRAD5_RTOL, phase="train5"):
    """d L.mean() / d param of the centre window's rays on the card
    (through both kernels) against the same rays, scene and uniforms on
    the CPU (through the kernels' plain versions): within rtol, finite
    and non-zero, for beta_m, beta_n and each sigma_a channel. The card
    and the CPU round the shading's transcendentals differently, so a
    rare path can take another branch; rtol bounds what that moves
    (``tests/test_torch_kernels_cuda.py`` calls this on a small
    config 5)."""
    import torch

    from yhair_tpu_torch.parallel import mesh

    pix = centre_pixels(width, height, window)

    def grads(scene, device):
        scp, params = trainable(scene)
        pid = torch.as_tensor(pix, device=device)
        L = mesh.trace_pixels(scp, cam.to(device), width, height, pid,
                              torch.zeros_like(pid), mesh.key_seed(0),
                              depth, device=device)
        L.double().mean().backward()
        return {k: p.grad.cpu().reshape(-1) for k, p in params.items()}

    card = grads(sc, dev)
    cpu = grads(sc.to("cpu"), torch.device("cpu"))
    pairs = []
    for k in card:
        for c in range(card[k].numel()):
            a, b = float(card[k][c]), float(cpu[k][c])
            rel = abs(a - b) / max(abs(b), 1e-30)
            pairs.append(dict(param=k if card[k].numel() == 1 else f"{k}[{c}]",
                              card=a, cpu=b, rel_err=rel))
            require(b != 0.0 and abs(a) < float("inf") and rel <= rtol,
                    phase, f"card-against-CPU gradient check: {pairs[-1]}")
    return pairs


def phase_scene5(dev):
    """Config 5 at its full size: the scene, its clusters and camera."""
    import torch

    from yhair_tpu_torch.apps import render as app

    t0 = time.time()
    sc, cam, _, _, _ = app.load_config(5, device=dev)
    torch.cuda.synchronize()
    cl = sc.accel
    real = (cl.seg_index >= 0).reshape(cl.n_clusters, -1)
    emit(phase="scene5", ok=True, segments=int(real.sum()),
         padded_segments=int(sc.segments.p0.shape[0]),
         clusters=cl.n_clusters, nonempty_clusters=int(real.any(1).sum()),
         tile_bytes=nbytes(cl.tc), triangles=sc.n_triangles,
         env_map=list(sc.env_map.shape[:2]), point_lights=sc.n_lights,
         area_lights=sc.n_area_lights,
         shadow_rays_per_bounce=shadow_rays_per_bounce(sc),
         seconds=time.time() - t0)
    return sc, cam


def phase_train5(sc, cam, dev):
    """Config 5's training path: the fwd+bwd frame (main5 warmed the
    forward, so no warm-up frame), the card-against-CPU gradients and
    three invert steps."""
    fields = bench_fwdbwd(sc, cam, dev, W5, H5, DEPTH5, warm_up=False,
                          phase="train5")
    fields["gradient_check"] = device_gradient_check(sc, cam, dev)
    fields.update(invert_steps(dev, (
        "--config", "5", "--resolution", str(W5), "--spp", str(SPP),
        "--bounces", str(DEPTH5), "--steps", "3", "--pixel-batch",
        str(INVERT5_BATCH)), phase="train5"))
    emit(phase="train5", ok=True, width=W5, height=H5, spp=SPP,
         depth=DEPTH5, strips=-(-W5 * H5 * SPP // STRIP),
         grad_window=GRAD5_WINDOW, grad_depth=GRAD5_DEPTH,
         grad_rtol=GRAD5_RTOL, **fields)


def phase_golden5(sc, cam, dev):
    """Config 5 at the golden's resolution and depth, on the first
    GOLDEN5_SPP of its 64 sample streams: the mean within 1% of the
    golden's. The p99 luminance of so few samples is noisier than the
    golden's, so it and the 256x256 box-downsample's difference from
    ``goldens/config5.pfm`` are printed, not gated."""
    import numpy as np

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.apps import render as app

    cfg = CONFIGS[5]
    with open(os.path.join(GOLDEN, "config5_stats.json")) as f:
        gold = json.load(f)
    ref = app.load_pfm(os.path.join(GOLDEN, "config5.pfm"))
    res = cfg["res"]
    t0 = time.perf_counter()
    img = app.progressive_render(sc, cam, res, res, GOLDEN5_SPP,
                                 cfg["depth"], seed=0, log=None, device=dev)
    seconds = time.perf_counter() - t0
    f = res // ref.shape[0]
    small = img.reshape(ref.shape[0], f, ref.shape[1], f, 3).mean((1, 3))
    mean = float(img.mean())
    mean_rel = abs(mean - gold["mean"]) / gold["mean"]
    p99 = float(np.percentile(img.mean(-1), 99))
    ok = bool(np.isfinite(img).all()) and mean_rel <= GOLDEN_MEAN_RTOL
    fields = dict(phase="golden5", ok=ok, config=5, res=res,
                  spp=GOLDEN5_SPP, golden_spp=cfg["spp"], depth=cfg["depth"],
                  seconds=seconds, mean=mean, golden_mean=gold["mean"],
                  mean_rel=mean_rel, mean_rtol=GOLDEN_MEAN_RTOL, p99_lum=p99,
                  golden_p99_lum=gold["p99_lum"],
                  p99_rel=abs(p99 - gold["p99_lum"]) / gold["p99_lum"],
                  small_res=ref.shape[0],
                  small_p99_lum=float(np.percentile(small.mean(-1), 99)),
                  golden_small_p99_lum=float(np.percentile(ref.mean(-1), 99)),
                  small_mean_abs_diff=float(np.abs(small - ref).mean()))
    require(ok, "golden5", json.dumps(fields))
    emit(**fields)


def phase_profile(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
                  strip_index=0, phase="profile", fwdbwd=True, top=12):
    """Device time per layer over one strip (torch.profiler); with
    fwdbwd, then the same strip forward and backward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from yhair_tpu_torch.geometry import triangles as tri
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    pid = strip_pixels(width, height, strip_index, dev)

    def strip():
        mesh.trace_pixels(sc, cam, width, height, pid, torch.zeros_like(pid),
                          mesh.key_seed(0), depth, device=dev)
        torch.cuda.synchronize()

    def labelled(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    # the list build and the triangle search are torch ops under labelled
    # ranges; the kernels are launched through ctypes, which the profiler
    # does not tie to a range, so they are found by their own names
    layers = {"layer:cluster_lists": (ik, "_block_cluster_lists"),
              "layer:triangles": (tri, "nearest_hit")}
    orig = {label: getattr(mod, name)
            for label, (mod, name) in layers.items()}
    strip()
    t0 = time.perf_counter()
    strip()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for label, (mod, name) in layers.items():
        setattr(mod, name, labelled(label, orig[label]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            strip()
    finally:
        for label, (mod, name) in layers.items():
            setattr(mod, name, orig[label])
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
    emit(phase=phase, ok=device_ms > 0, strip_rays=STRIP, depth=depth,
         strip_index=strip_index, wall_ms=wall_ms, device_ms=device_ms,
         device_idle_frac=1.0 - device_ms / wall_ms, layer_ms=by_layer,
         top_device_kernels=[{"name": e.key[:90], "calls": e.count,
                              "ms": e.self_device_time_total / 1e3}
                             for e in kernels[:top]])
    require(device_ms > 0, phase, "the profiler saw no device time")
    if not fwdbwd:
        return

    # one forward+backward strip: the backward is every function the
    # autograd engine evaluates
    scp, _ = trainable(sc)

    def train_strip():
        mesh.trace_pixels(scp, cam, width, height, pid, torch.zeros_like(pid),
                          mesh.key_seed(0), depth, device=dev).mean().backward()
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
    emit(phase=f"{phase}_fwdbwd", ok=device_ms > 0, strip_rays=STRIP,
         depth=depth, wall_ms=wall_ms, device_ms=device_ms,
         backward_device_ms=backward_ms,
         forward_device_ms=device_ms - backward_ms,
         device_idle_frac=1.0 - device_ms / wall_ms,
         peak_device_bytes=peak,
         autograd_functions=sum(
             e.count for e in avg if e.device_type == DeviceType.CPU
             and e.key.startswith("autograd::engine::evaluate_function:")))
    require(device_ms > 0 and backward_ms > 0, f"{phase}_fwdbwd",
            "the profiler saw no backward device time")


def kernel_record(name, replaces, st, launches, path):
    return {"name": name, "path": path, "route": "cuda",
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
                   help="also trace one bench strip and one config-5 strip "
                        "with torch.profiler")
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

    t_start = time.time()
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

    sc5, cam5 = phase_scene5(dev)
    strip5 = W5 * H5 // STRIP // 2      # the strip through the centre
    hit5, any5 = phase_kernels(sc5, cam5, dev, W5, H5, DEPTH5, strip5,
                               phase="kernels5")
    launches5 = phase_main(sc5, cam5, dev, W5, H5, DEPTH5, phase="main5")
    phase_train5(sc5, cam5, dev)
    phase_golden5(sc5, cam5, dev)
    if args.profile:
        phase_profile(sc, cam, dev)
        phase_profile(sc5, cam5, dev, W5, H5, DEPTH5, strip5,
                      phase="profile5", fwdbwd=False)
    emit(phase="total", ok=True, seconds=time.time() - t_start)

    records = []
    for suffix, path, lc, stats in (
            ("", "config 3, bench.py workload", launches,
             (hit_stats, any_stats)),
            (" (config 5)", "config 5, furry bunny", launches5, (hit5, any5))):
        records += [
            kernel_record("hit_kernel" + suffix,
                          "yhair_tpu/ops/intersect_kernel.py:186", stats[0],
                          lc["hit_kernel"], path),
            kernel_record("any_kernel" + suffix,
                          "yhair_tpu/ops/intersect_kernel.py:316", stats[1],
                          lc["any_kernel"], path)]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
