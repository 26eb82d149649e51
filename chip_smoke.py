#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``yhair_tpu_torch``) on one NVIDIA
card.

    python3 chip_smoke.py [--stop-after build|kernels|main]

Phases, each printed as one JSON line; any failure exits non-zero:

1. build    nvcc builds ``yhair_tpu_torch/csrc/*.cu`` and g++
            the native cluster builder (``native/cluster_builder.cpp``,
            which every scene build then takes: the phase fails if it is
            not available); the card's name and power limit are printed
            as nvidia-smi gives them.
2. kernels  one 65,536-ray strip of the bench workload (the 10k-strand
            hairball, 512x512, depth 4) is traced with every kernel
            launch recorded: the camera rays and every bounce's rays.
            Each recorded launch (every list build of ``lists_kernel``,
            every hit and any launch) is held against its plain PyTorch
            version (bit-equal), every nearest-hit search against the
            brute force on 1 ray in 16 (bit-equal winners), and every
            hit's t against the closed-form recompute (bit-equal).
            Kernel and plain times per launch are taken on these inputs.
            For each kind of launch (search and list capacity) it prints
            the mean and maximum list length and the kernels' work items.
            The any kernel's bound counts the visits a sequential walk
            needs until each block is dark (from any_pass_plain).
    hair3   the same strip traced again without autograd, every
            ``hair_kernel`` launch (one a bounce: the context, f and pdf
            towards both point lights, the BSDF sample) held against the
            plain twin ``bsdf/hair.hair_bounce`` on the same inputs on the
            card, every output bit for bit, and timed (CUDA events x5
            behind a device sleep) beside the twin and the bound (the
            twin's element operations a lane over the FP32 peak, against
            the bytes); nvcc's registers and spills of the kernel.
3. main     the bench workload through ``apps.render.progressive_render``
            (512x512, 1 spp, depth 4, four strips), with the launch
            counts set to 0 just before and read just after: one
            ``hair_kernel`` launch a bounce a strip, and every hair lane
            shaded by it (counters ``shade.hair_kernel``, ``shade.hair``).
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
6. kernels_inst3, inst3  config 3 posed as two instances of its one
            cluster build (identity; yaw 40 degrees, scale 1.1, offset
            (0.35, 0, 0.1)) with hair-material rows 0 and 1 (beta_m x
            1.6). ``kernels_inst3`` is ``kernels`` on the centre strip:
            every launch, made on rays in an instance's frame, bit-equal
            to its plain version, the searches against the brute force
            and the recompute over the canonical segments. ``inst3``:
            the instanced forward frame against the same two wigs baked
            into 240,000 segments in 2,048 clusters (>= 97% of the values
            within 5e-3), each frame's seconds, Mrays/s and launches, the
            instance box tests (one host sync each) and skips; then one
            forward+backward frame into the two-row table.
7. soft3    config 3 with edge_softness 0.2: d mean(L) / d radius scale
            and / d one segment's p0 on the centre 32x32 window at depth
            2, card against CPU within 1%; three ``invert
            --edge-softness 0.2`` steps.
8. curves   config 1's strand as one first-class Bezier curve against
            it tessellated into 8 segments (64x64, 4 spp, depth 2; >=
            99.5% of the pixels within 1e-2), then the control-point
            inverse of ``tests/test_curves.py:130`` (100 Adam steps; the
            last loss below 0.6x the first, the error below 0.8x).
9. full     the all-features scene of ``__graft_entry__.py`` (two posed
            instances, a curve, a textured area light, an env map, a
            textured plane) built without JAX: one ``train_step_fn`` step
            (16x16, 2 spp, depth 2, edge_softness 0.2) on the card and on
            the CPU, the loss and gradients within 1% of each other.
10. scene5  ladder config 5 (the furry bunny) at full size: 300,000 hair
            segments in 4,096 clusters (a power of two; 2,344 hold
            segments), an 800-triangle mesh, a plane, a point light and
            a 64x128 environment map.
11. kernels5 as ``kernels``, on the 65,536-ray strip through the centre
            of config 5's 1024x1024 frame at depth 6: every launch
            bit-equal to its plain version, with the count of blocks
            sent as the "scan every cluster" sentinel (lists longer
            than MAX_IDS).
    hair5   ``hair3`` on that strip (a point light and the env map's
            sample).
    triangles5  every triangle search of that strip (each bounce's
            nearest search through ``tri_hit_kernel``, its point-light
            and env-map shadow rays through ``tri_any_kernel``) held
            bit-equal to the plain twin ``geometry/triangles._search``,
            and timed (CUDA events x5) beside the twin and the bound.
12. main5   config 5's frame (1024x1024, 1 spp, depth 6, 16 strips)
            through ``progressive_render``, launch counts set to 0 just
            before and read just after.
13. train5  config 5's forward+backward frame (timed once: main5 warmed
            the forward) and its peak memory; the card-against-CPU
            gradient check (a 32x32 window at the centre, depth 2, the
            card's gradients within GRAD5_RTOL of the CPU's plain
            kernels on the same rays); ``invert --config 5 --resolution
            1024 --spp 1 --bounces 6 --steps 3 --pixel-batch 2048``.
14. golden5 config 5 at 1024x1024, depth 6, on the first 4 of the
            golden's 64 sample streams: the mean within 1% of
            ``goldens/config5_stats.json``; the p99 and the 256x256
            box-downsample's mean |diff| from ``goldens/config5.pfm``
            are printed.
15. invert5spec  config 5's inverse at spec (1024x1024, 64 spp, depth
            6, 2,048-pixel batches; ``ladder_gpu.py`` runs the whole
            120 steps) through ``invert`` on golden5's image, written to
            a temporary PFM, as the target: three steps in one run (the
            launch counts set to 0 just before and read just after),
            then two steps, a checkpoint and one resumed step, whose
            params, gradients and losses must equal the uninterrupted
            run's bit for bit; losses and gradients finite, every param
            moved; the resumed step's launches recorded and its first
            hit and any launch held against their plain versions
            (bit-equal); the seconds of each step.
16. scenefile3  (run after ``golden``) config 3 written as a scene file
            by ``apps.convert genscene`` and rendered by ``apps.render
            --scene`` at the bench frame: the HDR bit-equal to ``main``'s
            image, the PNG (read back by the port's decoder) equal to its
            8-bit tonemap, a 2-spp render resumed from a 1-spp
            ``--checkpoint`` bit-equal to the uninterrupted one, and
            ``invert --scene`` with ``train``'s argv: the first loss
            bit-equal to ``train``'s, the later ones within 1e-5.
17. scenefile5  config 5 written as a scene file and rendered by
            ``render --scene`` at 1024x1024, 1 spp, depth 6: every scene
            tensor equal to ``--config 5``'s but the env map's pmf and
            cdf (within 1e-7: the map goes through a float32 PFM); the
            image's mean within 0.1% of ``main5``'s and >= 99.9% of its
            values within 5e-3. Load and frame seconds, file bytes,
            Mrays/s, launches.
18. scene4, kernels4  ladder config 4 (the scalp model: 300,000
            segments in 4,096 clusters) and ``kernels`` on the centre
            strip of its 512x512 frame at depth 6.
19. ladder  config 4 at its spec (512x512, depth 6) through
            ``progressive_render`` on the first 8 of the golden's 32
            sample streams (the only cut), launch counts set to 0 just
            before and read just after: the mean within 1% of
            ``goldens/config4_stats.json``.
20. bvh     config 3's full geometry built with ``accel="bvh"`` on the
            card (120,000 segments, leaf size 4: 32,768 leaves), whose
            skip-pointer walk is torch ops with a host sync every 16
            steps and no kernel of its own. (a) Strip 0's 65,536 camera
            rays against the cluster kernel: hit masks equal, original
            ids equal on >= 99.9%, t within 1e-6 relative. (b) The bench
            frame (512x512, 1 spp) cut to depth 1 (from the second
            bounce on, every shadow query of a dead lane walks all
            65,535 nodes: see BVH_FRAME_DEPTH) through the BVH against
            the cluster kernels' frame at that depth (q99.9 < 1e-4,
            mean < 1e-5, the gates of ``tests/test_bvh.py:69-70``), cut
            to strip 0 (and saying so) if the whole frame would take
            more than 150 s. The walk's steps per query, ms per query
            and the seconds are printed.
21. ranks   the multi-rank path (``parallel.mesh.render_fn`` and
            ``train_step_fn`` over a ``torch.distributed`` group), in
            spawned processes on the one card: world size 1 over NCCL,
            2 over gloo (NCCL refuses two ranks on one device; both
            ranks on cuda:0). Each rank's bench frame bit-equal to
            ``main``'s image; one train step at 512x512 on a
            65,536-pixel batch: world size 2's loss within 1e-6 and
            gradients within 1e-4 relative of world size 1's (world
            size 1 run twice shows the run-to-run spread), the params
            equal on both ranks. Launch counts are set to 0 just before
            each rank's frame and step and read just after; each
            all-reduce's ms (after a barrier, whose wait is printed
            apart). A four-card NCCL run is not possible on a one-card
            machine and is not made.

A ``total`` line gives the script's seconds.
The line before the last is the ``kernels`` record (each kernel on the
config-3, the config-5, the instanced, the config-4 and the config-5
inverse path), the last one
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
# FP32 operations of one ray-segment test and of one (ray, cluster) slab
# test (csrc/intersect.cu's note)
FLOP_PER_TEST = 55
TESTS_PER_VISIT = 128 * 128
FLOP_PER_SLAB = 28

WIDTH = HEIGHT = 512
SPP, DEPTH, STRIP = 1, 4, 65536
GOLDEN_MEAN_RTOL, GOLDEN_P99_RTOL = 0.01, 0.03
# the LAUNCHES keys of the cluster search and of the triangle search
CLUSTER_KERNELS = ("lists_kernel", "hit_kernel", "any_kernel")
TRIANGLE_KERNELS = ("tri_hit_kernel", "tri_any_kernel")
# device cycles of the sleep queued before a timed run of launches (about
# 10 ms at the H100's 1.98 GHz): the host queues them meanwhile
HOST_LEAD_CYCLES = 20_000_000
# bench.py differentiates with respect to these
TRAIN_PARAMS = ("beta_m", "beta_n", "sigma_a")
FD_EPS, FD_RTOL = 1e-3, 0.02
# config 5 (the furry bunny under an environment map) at its golden's
# resolution and depth
W5 = H5 = 1024
DEPTH5 = 6
# config 4 (the scalp model) at its golden's resolution and depth
W4 = H4 = 512
DEPTH4 = 6
GOLDEN5_SPP = 4
INVERT5_BATCH = 2048
# the spec inverse's samples per pixel (BASELINE.json's config 5)
SPEC5_SPP = 64
GRAD5_WINDOW, GRAD5_DEPTH, GRAD5_RTOL = 32, 2, 1e-2
# config 3 posed twice (tests/test_instances.py:32-38), hair-material
# rows 0 and 1; the reference's gate of instanced against baked
_C40, _S40 = 0.766044443118978, 0.6427876096865393
INST_FRAMES = [[[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]],
               [[_C40 * 1.1, 0, -_S40 * 1.1], [0, 1.1, 0],
                [_S40 * 1.1, 0, _C40 * 1.1], [0.35, 0.0, 0.1]]]
INST_TOL, INST_CLOSE = 5e-3, 0.97
# soft silhouettes on config 3
SOFT = 0.2
SOFT_WINDOW, SOFT_DEPTH, SOFT_RTOL = 32, 2, 1e-2
# config 4 (the scalp model) at its spec on the first LADDER_SPP of the
# golden's 32 sample streams
LADDER_SPP = 8
# invert --scene against invert --config 3: later steps may move by the
# ulps of the backward's atomic scatter-adds
INVERT_LOSS_RTOL = 1e-5
# config 5 from a scene file against --config 5: the env map goes through
# a float32 PFM, so its pmf and cdf (built in float64) move by ulps
ENV_TABLE_ATOL = 1e-7
SCENE5_MEAN_RTOL, SCENE5_TOL, SCENE5_CLOSE = 1e-3, 5e-3, 0.999
# config 3 through the BVH walk (torch ops): strip 0's camera rays against
# the cluster kernel, then the bench frame at BVH_FRAME_DEPTH against the
# cluster kernels' under tests/test_bvh.py:69-70's gates, cut to strip 0
# if the whole frame would take longer than BVH_FRAME_BUDGET_S. Depth 1:
# from the second bounce on, the lanes that died sit at 1e8 and cast
# their shadow rays back along -(1, 1, 1) / sqrt(3); in float32 every box
# then collapses to one point, so each such query walks all 65,535 nodes
# (the reference's walk does the same): strip 0 at the bench depth of 4
# takes about 10 minutes on an H100
BVH_LEAF = 4
BVH_T_RTOL, BVH_ID_FRAC = 1e-6, 0.999
BVH_Q999, BVH_MEAN = 1e-4, 1e-5
BVH_FRAME_DEPTH, BVH_FRAME_BUDGET_S = 1, 150.0
# the multi-rank path on the one card: world size 1 over NCCL, 2 over
# gloo (NCCL refuses two ranks on one device); one train step with a
# STRIP-pixel batch from params RANKS_START x the scene's. The loss is a
# sum of squares (only the order of its sums moves); the gradients are
# sums whose terms cancel (beta_m's most), and the backward's atomic
# scatter-adds reorder them from run to run
RANKS = (("nccl", 1), ("gloo", 2))
RANKS_START, RANKS_LR, RANKS_SEED = 1.25, 5e-2, 1
RANKS_LOSS_RTOL, RANKS_GRAD_RTOL = 1e-6, 1e-4
RANKS_TIMEOUT_S = 300


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
        self.hit, self.any, self.nearest, self.lists = [], [], [], []

    def __enter__(self):
        import torch
        ik = self.ik
        self.orig = (ik.hit_pass, ik.any_pass, ik.nearest_hit,
                     ik._block_cluster_lists)
        hit_pass, any_pass, nearest_hit, lists = self.orig

        def rec_lists(o, d, cl, t_max=None, exclude_below=None,
                      return_key=False):
            args = (o, d, cl, t_max, exclude_below, return_key)
            out = lists(*args)
            self.lists.append((args, out))
            return out

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

        (ik.hit_pass, ik.any_pass, ik.nearest_hit,
         ik._block_cluster_lists) = (rec_hit, rec_any, rec_nearest,
                                     rec_lists)
        return self

    def __exit__(self, *exc):
        ik = self.ik
        (ik.hit_pass, ik.any_pass, ik.nearest_hit,
         ik._block_cluster_lists) = self.orig


class TriRecorder:
    """Wraps the triangle searches of ``geometry.triangles`` (``search``,
    which ``nearest_hit`` calls, and ``occluded``) for the span of a
    ``with``, keeping every call's inputs and outputs. Launches still go
    through the wrappers."""

    def __init__(self):
        self.hit, self.any = [], []

    def __enter__(self):
        from yhair_tpu_torch.geometry import triangles as tri
        self.orig = (tri.search, tri.occluded)
        search, occluded = self.orig

        def rec_search(o, d, tris, t_min=1e-4, t_max=tri.INF, chunk=2048):
            out = search(o, d, tris, t_min, t_max, chunk)
            self.hit.append(((o, d, tris, t_min, t_max, chunk), out))
            return out

        def rec_occluded(o, d, dist, tris, t_min=1e-4, chunk=2048):
            out = occluded(o, d, dist, tris, t_min, chunk)
            self.any.append(((o, d, dist, tris, t_min, chunk), out))
            return out
        tri.search, tri.occluded = rec_search, rec_occluded
        return self

    def __exit__(self, *exc):
        from yhair_tpu_torch.geometry import triangles as tri
        tri.search, tri.occluded = self.orig


class HairRecorder:
    """Wraps ``bsdf.hair.hair_bounce_kernel`` for the span of a ``with``,
    keeping every call's inputs and outputs. Launches still go through
    the wrapper."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from yhair_tpu_torch.bsdf import hair as th
        self.orig = th.hair_bounce_kernel
        orig = self.orig

        def rec(*args):
            out = orig(*args)
            self.calls.append((args, out))
            return out
        th.hair_bounce_kernel = rec
        return self

    def __exit__(self, *exc):
        from yhair_tpu_torch.bsdf import hair as th
        th.hair_bounce_kernel = self.orig


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


def timed_device(fn, reps=5):
    """(last result, mean device ms) of reps calls of fn queued behind a
    device sleep, so the events time the device's work and not the
    host's launches."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
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
    from yhair_tpu_torch import kernels
    from yhair_tpu_torch.accel import native
    t0 = time.time()
    lib, log = kernels.build()
    kernels.library()
    # the scene builds take the native cluster builder (g++): a failed
    # build raises here, and a missing g++ fails the phase
    native_lib = native.build()
    require(native.available(), "build",
            "the native cluster builder is not available (no g++?)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas = ptxas_lines(log)
    emit(phase="build", ok=True, seconds=time.time() - t0,
         library=os.path.relpath(lib, ROOT),
         native_library=os.path.relpath(native_lib, ROOT),
         ptxas=ptxas, nvidia_smi=smi)
    return smi, ptxas


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


def hold_hit(st, kinds, args, out, c, phase):
    """One recorded hit launch against hit_pass_plain (bit-equal), then
    timed: adds its ms, plain ms and bound to st and its list to kinds."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik

    o, d, seeds, ids, counts, tc, k_cap = args
    ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, c)
    list_stats(kinds, f"hit k_cap={k_cap}", counts_p, k_cap)
    plain, ms_plain = timed(lambda: ik.hit_pass_plain(
        o, d, seeds, ids_p, counts_p, tc, k_cap))
    for name, a, b in zip(("t", "idx", "oid"), out, plain):
        require(torch.equal(a, b), phase,
                f"hit kernel {name} differs from hit_pass_plain "
                f"({int((a != b).sum())} rays)")
    st["max_abs_err"] = max(st["max_abs_err"],
                            float((out[0] - plain[0]).abs().max()))
    _, ms = timed(lambda: ik.hit_pass(*args), 5)
    add_bound(st, *bound_ms(
        int(counts_p.sum()),
        nbytes(o, d, *seeds, ids_p, counts_p, tc, *out)))
    st["ms"] += ms
    st["plain_ms"] += ms_plain


def hold_any(st, kinds, args, out, visits, c, phase):
    """One recorded any launch against any_pass_plain (bit-equal), then
    timed, as ``hold_hit``."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik

    o, d, t_cap, ids, counts, tc, k_cap = args
    ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, c)
    ls = list_stats(kinds, f"any k_cap={k_cap}", counts_p, k_cap)
    (plain, need), ms_plain = timed(lambda: ik.any_pass_plain(
        o, d, t_cap, ids_p, counts_p, tc, k_cap, return_visits=True))
    require(torch.equal(out, plain), phase,
            f"any kernel differs from any_pass_plain "
            f"({int((out != plain).sum())} rays)")
    # the bound counts what a sequential front-to-back walk needs,
    # whatever extra work the kernel's parallel items did
    ls["needed_visits"] = ls.get("needed_visits", 0) + int(need.sum())
    ls["kernel_visits"] = ls.get("kernel_visits", 0) + int(visits.sum())
    _, ms = timed(lambda: ik.any_pass(*args), 5)
    add_bound(st, *bound_ms(
        int(need.sum()), nbytes(o, d, t_cap, ids_p, counts_p, tc, out)))
    st["ms"] += ms
    st["plain_ms"] += ms_plain


def hold_lists(st, args, out, phase):
    """One recorded list build against _block_cluster_lists_plain
    (bit-equal ids, counts and, where it was asked for, key), then timed
    (CUDA events x5). The bound: live rays (t_max >= T_MIN) x C slab tests
    of FLOP_PER_SLAB operations over the FP32 peak, against the inputs
    read once and the outputs written once over HBM's rate."""
    import torch

    from yhair_tpu_torch.ops import intersect_kernel as ik

    o, d, cl, t_max, exclude, _ = args
    plain, ms_plain = timed(lambda: ik._block_cluster_lists_plain(
        o, d, cl, t_max, exclude, return_key=True))
    for name, a, b in zip(("ids", "counts", "key"), out, plain):
        require(torch.equal(a, b), phase,
                f"lists kernel {name} differs from the plain twin "
                f"({int((a != b).sum())} entries)")
    _, ms = timed(lambda: ik._block_cluster_lists(*args), 5)
    live = (o.shape[0] if t_max is None
            else int((t_max >= ik.T_MIN).sum()))
    add_bound(st, live * cl.n_clusters * FLOP_PER_SLAB / FP32_PEAK * 1e3,
              nbytes(o, d, cl.cmin, cl.cmax,
                     *(x for x in (t_max, exclude) if x is not None), *out)
              / HBM_BYTES_S * 1e3)
    st["ms"] += ms
    st["plain_ms"] += ms_plain


def occlusion_tests(o, d, dist, tris, t_min):
    """Ray-triangle tests a walk over the triangles in index order needs
    until each ray is occluded (all of them where it is not)."""
    import torch

    from yhair_tpu_torch.geometry import triangles as tri

    n_tri, limit, total = tris.n_triangles, dist * (1.0 - 1e-4), 0
    for lo in range(0, o.shape[0], tri.RAY_CHUNK):
        hi = lo + tri.RAY_CHUNK
        t, _, _ = tri._mt_hit(o[lo:hi, None], d[lo:hi, None], tris.v0[None],
                              tris.v1[None], tris.v2[None], t_min, tri.INF)
        occ = t < limit[lo:hi, None]
        first = torch.where(occ.any(1), occ.int().argmax(1) + 1, n_tri)
        total += int(first.sum())
    return total


def hold_tri(st, kind, args, out, phase):
    """One recorded triangle search ("hit": ``search``, "any":
    ``occluded``) against the plain twin ``_search`` (bit-equal t and
    idx, or occlusion), then timed (CUDA events x5). The bound: the
    ray-triangle tests the search needs (every pair for the nearest hit;
    up to each ray's first occluder for occlusion) of FLOP_PER_TEST
    operations over the FP32 peak, against the inputs read once and the
    outputs written once over HBM's rate."""
    import torch

    from yhair_tpu_torch.geometry import triangles as tri

    if kind == "hit":
        o, d, tris = args[:3]
        plain, ms_plain = timed(lambda: tri._search(*args))
        for name, a, b in zip(("t", "idx"), out, plain):
            require(torch.equal(a, b), phase,
                    f"triangle hit kernel {name} differs from the twin "
                    f"({int((a != b).sum())} rays)")
        _, ms = timed(lambda: tri.search(*args), 5)
        tests = o.shape[0] * tris.n_triangles
        n_bytes = nbytes(o, d, tris.v0, tris.v1, tris.v2, *out)
    else:
        o, d, dist, tris, t_min, chunk = args
        (least, _), ms_plain = timed(lambda: tri._search(
            o, d, tris, t_min, tri.INF, chunk))
        plain = least < dist * (1.0 - 1e-4)
        require(torch.equal(out, plain), phase,
                f"triangle any kernel differs from the twin "
                f"({int((out != plain).sum())} rays)")
        _, ms = timed(lambda: tri.occluded(*args), 5)
        tests = occlusion_tests(o, d, dist, tris, t_min)
        n_bytes = nbytes(o, d, dist, tris.v0, tris.v1, tris.v2, out)
    add_bound(st, tests * FLOP_PER_TEST / FP32_PEAK * 1e3,
              n_bytes / HBM_BYTES_S * 1e3)
    st["tests"] = st.get("tests", 0) + tests
    st["ms"] += ms
    st["plain_ms"] += ms_plain


def per_launch(st):
    """Turn st's sums into means per compared launch; name the bound."""
    n = max(st["launches"], 1)
    for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
        st[k] /= n
    st["bound_by"] = ("operations" if st["ops_ms"] >= st["bytes_ms"]
                      else "bytes")


def launch_ms(hit_stats, any_stats, lists_stats):
    return {k: {f: st[f] for f in ("ms", "plain_ms", "bound_ms", "ops_ms",
                                   "bytes_ms")}
            for k, st in (("lists", lists_stats), ("hit", hit_stats),
                          ("any", any_stats))}


def phase_kernels(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
                  strip=0, phase="kernels"):
    """Every launch of one strip against its plain version."""
    import torch

    from yhair_tpu_torch.geometry import segments as seg
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    from yhair_tpu_torch.accel.instanced import InstancedClusters

    # posed instances run the kernels on rays in each instance's frame,
    # against the canonical clusters
    cl = sc.accel.cl if isinstance(sc.accel, InstancedClusters) else sc.accel
    c = cl.n_clusters
    pid = strip_pixels(width, height, strip, dev)
    with Recorder(ik) as rec:
        img = mesh.trace_pixels(sc, cam, width, height, pid,
                                torch.zeros_like(pid), mesh.key_seed(0),
                                depth, device=dev)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(img).all()), phase, "strip not finite")
    kinds = {}

    lists_stats = new_stats(len(rec.lists))
    for args, out in rec.lists:
        hold_lists(lists_stats, args, out, phase)
    hit_stats = new_stats(len(rec.hit))
    for args, out in rec.hit:
        hold_hit(hit_stats, kinds, args, out, c, phase)
    any_stats = new_stats(len(rec.any))
    for args, out, visits in rec.any:
        hold_any(any_stats, kinds, args, out, visits, c, phase)

    sentinel = sentinel_check(rec, c, phase) if c > ik._k_cap(c) else None

    # the two-pass searches against the brute force, and each hit's t
    # against the integrator's closed-form recompute (both in the frame
    # the kernels saw: an instance's, over the canonical segments)
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

    for st in (lists_stats, hit_stats, any_stats):
        per_launch(st)
    emit(phase=phase, ok=True, strip_rays=STRIP, depth=depth,
         strip_index=strip, lists_launches=lists_stats["launches"],
         hit_launches=hit_stats["launches"],
         any_launches=any_stats["launches"], nearest_searches=len(
             rec.nearest), brute_force_rays=n_brute, recomputed_hits=n_hits,
         kernel_vs_plain="bit-equal", brute_force="bit-equal winners",
         recompute="bit-equal t", chunk=ik.CHUNK, clusters=c,
         k_cap=ik._k_cap(c),
         sentinel_blocks=sum(v["sentinel_blocks"] for v in kinds.values()),
         sentinel_check=sentinel,
         per_launch_ms=launch_ms(hit_stats, any_stats, lists_stats),
         lists=summarize_kinds(kinds))
    return hit_stats, any_stats, lists_stats


def hair_ops_per_lane(args):
    """FP32 element operations a lane of one hair_kernel launch, as the
    plain twin counts them: the elements of every aten op it runs (the
    context, f and the pdf at each direction, the sample and f and the
    pdf there) on its first 256 lanes, over 256."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from yhair_tpu_torch.bsdf import hair as th

    views = {"detach", "view", "unsqueeze", "expand", "select", "slice",
             "alias", "unbind", "_unsafe_view", "t", "as_strided"}

    class Count(TorchDispatchMode):
        elements = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in views:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.elements += sum(o.numel() for o in outs
                                      if isinstance(o, torch.Tensor))
            return out

    mat, mat_id, h, wo, wis, u = args
    k = 256
    lanes = th.material_at(mat, None if mat_id is None else mat_id[:k])
    inputs = (h[:k], wo[:k], [w[:k] for w in wis], u[:k])
    with Count():
        th.hair_bounce(lanes, *inputs)
    return Count.elements / k


def hold_hair(st, args, out, phase):
    """One recorded hair_kernel launch against the plain twin (the torch
    code on the same inputs, on the card), every output bit for bit,
    then timed (CUDA events x5). The bound: the twin's element
    operations a lane (``hair_ops_per_lane``) over the FP32 peak, against
    the inputs read once (a lane's 4 uniforms as 16 bytes) and the
    outputs written once over HBM's rate."""
    import torch

    from yhair_tpu_torch.bsdf import hair as th

    mat, mat_id, h, wo, wis, u = args
    twin, ms_plain = timed(lambda: th.hair_bounce(
        th.material_at(mat, mat_id), h, wo, wis, u))
    names = ["f", "pdf", "wi_h", "f_h", "pdf_h"]
    for name, a, b in zip(names, out, twin):
        for j, (x, y) in enumerate(zip(a, b) if name in ("f", "pdf")
                                   else [(a, b)]):
            same = ((x.view(torch.int32) == y.view(torch.int32))
                    | (torch.isnan(x) & torch.isnan(y)))
            require(bool(same.all()), phase,
                    f"hair kernel {name}[{j}] differs from the twin in "
                    f"{int((~same).sum())} of {same.numel()} values")
    _, ms = timed_device(lambda: th.hair_bounce_kernel(*args), 5)
    n, k = h.shape[0], len(wis)
    if "ops_per_lane" not in st:
        st["ops_per_lane"] = hair_ops_per_lane(args)
    n_bytes = (nbytes(h, wo, th.material_table(mat), *wis, *out[0],
                      *out[1], *out[2:])
               + n * 16 + (0 if mat.beta_m.ndim == 0 else 4 * n))
    add_bound(st, n * st["ops_per_lane"] / FP32_PEAK * 1e3,
              n_bytes / HBM_BYTES_S * 1e3)
    st["directions"] = k
    st["ms"] += ms
    st["plain_ms"] += ms_plain


def phase_hair(sc, cam, dev, ptxas, width=WIDTH, height=HEIGHT, depth=DEPTH,
               strip=0, phase="hair3"):
    """Every hair_kernel launch of one strip (one a bounce) against the
    plain twin, bit for bit, and timed. -> the launch stats."""
    import torch

    from yhair_tpu_torch import kernels
    from yhair_tpu_torch.parallel import mesh

    pid = strip_pixels(width, height, strip, dev)
    before = kernels.LAUNCHES["hair_kernel"]
    with HairRecorder() as rec, torch.no_grad():
        img = mesh.trace_pixels(sc, cam, width, height, pid,
                                torch.zeros_like(pid), mesh.key_seed(0),
                                depth, device=dev)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(img).all()), phase, "strip not finite")
    launched = kernels.LAUNCHES["hair_kernel"] - before
    require(len(rec.calls) == depth == launched, phase,
            f"{launched} hair_kernel launches, {len(rec.calls)} calls, "
            f"at depth {depth}: one a bounce expected")
    st = new_stats(len(rec.calls))
    for args, out in rec.calls:
        hold_hair(st, args, out, phase)
    per_launch(st)
    entry = [i for i, ln in enumerate(ptxas)
             if "Compiling entry function" in ln and "hair_kernel" in ln]
    emit(phase=phase, ok=True, strip_rays=STRIP, depth=depth,
         strip_index=strip, launches=st["launches"],
         directions=st["directions"], kernel_vs_plain="bit-equal",
         ops_per_lane=st["ops_per_lane"],
         ptxas=ptxas[entry[0]:entry[0] + 3] if entry else None,
         per_launch_ms={f: st[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "ops_ms", "bytes_ms")},
         bound_by=st["bound_by"])
    return st


def phase_triangles(sc, cam, dev, width, height, depth, strip,
                    phase="triangles5"):
    """Every triangle search of one strip (the nearest searches and the
    shadow rays of every bounce) against the plain twin, bit for bit,
    and timed. -> (hit stats, any stats), as ``phase_kernels``'s."""
    import torch

    from yhair_tpu_torch import kernels
    from yhair_tpu_torch.parallel import mesh

    pid = strip_pixels(width, height, strip, dev)
    with TriRecorder() as rec:
        img = mesh.trace_pixels(sc, cam, width, height, pid,
                                torch.zeros_like(pid), mesh.key_seed(0),
                                depth, device=dev)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(img).all()), phase, "strip not finite")
    require(len(rec.hit) == depth and len(rec.any) > 0, phase,
            f"{len(rec.hit)} nearest and {len(rec.any)} shadow searches "
            f"over the triangles at depth {depth}")
    hit_st, any_st = new_stats(len(rec.hit)), new_stats(len(rec.any))
    for args, out in rec.hit:
        hold_tri(hit_st, "hit", args, out, phase)
    for args, out in rec.any:
        hold_tri(any_st, "any", args, out, phase)
    tests = {k: st["tests"] / st["launches"]
             for k, st in (("tri_hit", hit_st), ("tri_any", any_st))}
    for st in (hit_st, any_st):
        per_launch(st)
    emit(phase=phase, ok=True, strip_rays=STRIP, depth=depth,
         strip_index=strip, triangles=sc.n_triangles,
         lanes=kernels.library().yhair_tri_lanes(STRIP, sc.n_triangles),
         hit_launches=hit_st["launches"], any_launches=any_st["launches"],
         kernel_vs_plain="bit-equal", tests_per_launch=tests,
         per_launch_ms={k: {f: st[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "ops_ms", "bytes_ms")}
                        for k, st in (("tri_hit", hit_st),
                                      ("tri_any", any_st))})
    return hit_st, any_st


def shadow_rays_per_bounce(sc):
    """Shadow rays the integrator casts for each live bounce ray: one per
    point light, one for the environment map, one for the area lights."""
    from yhair_tpu_torch.core.envmap import has_env
    return sc.n_lights + int(has_env(sc)) + int(sc.n_area_lights > 0)


def phase_main(sc, cam, dev, width=WIDTH, height=HEIGHT, depth=DEPTH,
               phase="main", emit_line=True):
    """A forward frame through ``progressive_render``, the launch counts
    set to 0 just before and read just after. -> (launches, image, the
    printed fields)."""
    import numpy as np
    import torch

    from yhair_tpu_torch import kernels
    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.utils import trace

    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    trace.enable()
    try:
        t0 = time.perf_counter()
        img = app.progressive_render(sc, cam, width, height, SPP, depth,
                                     seed=0, log=None, device=dev)
        frame_s = time.perf_counter() - t0
        counts = trace.counters()
    finally:
        trace.disable()
    n_alive = counts["rays.bounce_live"]
    n_shadow = counts["rays.shadow_live"]
    launches = cluster_launches()
    require(img.shape == (height, width, 3) and bool(np.isfinite(img).all()),
            phase, "image not finite or of the wrong shape")
    require(all(n > 0 for n in launches.values()), phase,
            f"a kernel was not launched on the main path: {launches}")
    if sc.n_triangles:
        # every ray searched against the triangles went to a kernel
        launches.update((k, kernels.LAUNCHES[k]) for k in TRIANGLE_KERNELS)
        require(all(launches[k] for k in TRIANGLE_KERNELS)
                and counts["tri.rays_kernel"] == counts["tri.rays"], phase,
                f"triangle searches not all on the kernels: {launches}, "
                f"{counts['tri.rays_kernel']} of {counts['tri.rays']} rays")
    n_rays = width * height * SPP
    # one hair_kernel launch a bounce a strip, every hair lane on it
    launches["hair_kernel"] = kernels.LAUNCHES["hair_kernel"]
    require(launches["hair_kernel"] == -(-n_rays // STRIP) * depth
            and counts["shade.hair_kernel"] == counts["shade.hair"], phase,
            f"hair shading not all on the kernel: {launches}, "
            f"{counts.get('shade.hair_kernel')} of {counts['shade.hair']} "
            f"hair lanes")
    rays = n_rays * depth * (1 + shadow_rays_per_bounce(sc))
    lanes = counts["rays.bounce_lanes"] + counts["rays.shadow_lanes"]
    require(lanes == rays, phase, f"{lanes} lanes searched, {rays} counted")
    fields = dict(width=width, height=height, spp=SPP, depth=depth,
                  strips=-(-n_rays // STRIP), frame_s=frame_s,
                  mrays_s=rays / frame_s / 1e6,
                  alive_frac=(n_alive + n_shadow) / rays,
                  alive_bounce_rays=n_alive, live_shadow_rays=n_shadow,
                  launches=launches, image_mean=float(img.mean()),
                  peak_device_bytes=torch.cuda.max_memory_allocated())
    if emit_line:
        emit(phase=phase, ok=True, **fields)
    return launches, img, fields


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
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame()
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = cluster_launches()
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
                invert_losses=res["losses"],
                invert_final_grads=res["final_grads"],
                invert_recovered=res["recovered"], invert_true=res["true"],
                invert_log=log.getvalue().splitlines())


def phase_train(sc, cam, dev):
    """-> the ``invert`` steps' losses."""
    fields = bench_fwdbwd(sc, cam, dev)
    fields["gradient_check"] = gradient_check(sc, cam, dev)
    fields.update(invert_steps(dev))
    emit(phase="train", ok=True, width=WIDTH, height=HEIGHT, spp=SPP,
         depth=DEPTH, strips=-(-WIDTH * HEIGHT * SPP // STRIP),
         fd_eps=FD_EPS, fd_rtol=FD_RTOL, **fields)
    return fields["invert_losses"]


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


def zero_launches():
    from yhair_tpu_torch import kernels
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def cluster_launches():
    """The cluster search's launch counts in the one ``LAUNCHES``."""
    from yhair_tpu_torch import kernels
    return {k: kernels.LAUNCHES[k] for k in CLUSTER_KERNELS}


def read_launches(phase):
    """The launch counts since ``zero_launches``; both kernels must have
    run."""
    launches = cluster_launches()
    require(all(n > 0 for n in launches.values()), phase,
            f"a kernel was not launched on this path: {launches}")
    return launches


def quiet(main, argv):
    """(result, printed lines) of one CLI call."""
    import contextlib
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = main(argv)
    return res, log.getvalue().splitlines()


def genscene(generator, directory):
    """``apps.convert genscene`` into directory -> (scene.json path, the
    files' bytes)."""
    from yhair_tpu_torch.apps import convert

    os.makedirs(directory)
    path = os.path.join(directory, "scene.json")
    quiet(convert.main, ["genscene", generator, path])
    return path, sum(os.path.getsize(os.path.join(directory, f))
                     for f in os.listdir(directory))


def render_cli(phase, scene, res, spp, depth, out, dev, *extra):
    """``apps.render --scene`` to out.png and out.pfm, launch counts set
    to 0 just before and read just after -> (result, launches)."""
    from yhair_tpu_torch.apps import render as app

    zero_launches()
    res_, _ = quiet(app.main, [
        "--scene", scene, "--resolution", str(res), "--spp", str(spp),
        "--bounces", str(depth), "--output", out + ".png", "--hdr",
        out + ".pfm", "--device", str(dev), *extra])
    return res_, read_launches(phase)


def phase_scenefile3(img3, train_losses, dev):
    """Config 3 written as a scene file (``convert genscene``), rendered
    by ``render --scene`` at the bench frame: its HDR equals the ``main``
    phase's image bit for bit, and its PNG, read back by the port's own
    decoder, the 8-bit tonemap of that image. A 2-spp render interrupted
    after sample 1 (``--checkpoint``) equals the uninterrupted one bit
    for bit. ``invert --scene`` with the ``train`` phase's argv: its
    first loss bit-equal to that phase's, the later ones within
    INVERT_LOSS_RTOL."""
    import tempfile

    import numpy as np

    from yhair_tpu_torch.io import image as img_io

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene, file_bytes = genscene("curly_hairball",
                                     os.path.join(tmp, "config3"))
        write_s = time.perf_counter() - t0
        out = os.path.join(tmp, "frame")
        res, launches = render_cli("scenefile3", scene, WIDTH, SPP, DEPTH,
                                   out, dev)
        hdr = img_io.load_pfm(out + ".pfm")
        require(np.array_equal(hdr, img3.astype(np.float32)), "scenefile3",
                "render --scene differs from the main phase's frame on "
                f"{int((hdr != img3.astype(np.float32)).sum())} values")
        with open(out + ".png", "rb") as f:
            png = img_io.decode_png(f.read())
        require(np.array_equal(png, img_io.to_ldr(img3)), "scenefile3",
                "the PNG does not hold the tonemapped frame")

        ck = os.path.join(tmp, "render.ckpt.npz")
        render_cli("scenefile3", scene, WIDTH, 1, DEPTH,
                   os.path.join(tmp, "s1"), dev, "--checkpoint", ck)
        resumed, _ = render_cli("scenefile3", scene, WIDTH, 2, DEPTH,
                                os.path.join(tmp, "resumed"), dev,
                                "--checkpoint", ck)
        whole, _ = render_cli("scenefile3", scene, WIDTH, 2, DEPTH,
                              os.path.join(tmp, "whole"), dev)
        require(np.array_equal(resumed["image"], whole["image"]),
                "scenefile3", "the resumed 2-spp render differs from the "
                "uninterrupted one")

        inv = invert_steps(dev, (
            "--scene", scene, "--resolution", str(WIDTH), "--spp", str(SPP),
            "--bounces", str(DEPTH), "--steps", "3", "--pixel-batch",
            str(STRIP)), phase="scenefile3")
    losses = inv["invert_losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
    fields = dict(phase="scenefile3", ok=True, file_bytes=file_bytes,
                  write_s=write_s, load_s=res["load_s"],
                  frame_s=res["render_s"], launches=launches,
                  hdr_vs_main="bit-equal", png_vs_tonemap="equal",
                  resume_vs_whole="bit-equal",
                  invert_losses=losses, train_losses=train_losses,
                  invert_loss_rel=rel, invert_loss_rtol=INVERT_LOSS_RTOL,
                  invert_seconds=inv["invert_seconds"])
    require(losses[0] == train_losses[0], "scenefile3",
            f"invert --scene's first loss differs: {json.dumps(fields)}")
    require(max(rel) <= INVERT_LOSS_RTOL, "scenefile3",
            f"invert --scene's losses differ: {json.dumps(fields)}")
    emit(**fields)


def scene_tensors(tree, prefix=""):
    """{dotted name: tensor} of a Scene's tensors (NamedTuples flattened)."""
    import torch
    out = {}
    for name, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(scene_tensors(v, f"{prefix}{name}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + name] = v
    return out


def phase_scenefile5(sc5, img5, dev):
    """Config 5 written as a scene file and rendered by ``render --scene``
    at 1024x1024, 1 spp, depth 6: every scene tensor equals ``--config
    5``'s, but the env map's pmf and cdf, within ENV_TABLE_ATOL; the
    image against ``main5``'s: mean within SCENE5_MEAN_RTOL, at least
    SCENE5_CLOSE of the values within SCENE5_TOL."""
    import tempfile

    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene, file_bytes = genscene("furry_bunny",
                                     os.path.join(tmp, "config5"))
        write_s = time.perf_counter() - t0
        res, launches = render_cli("scenefile5", scene, W5, SPP, DEPTH5,
                                   os.path.join(tmp, "frame"), dev)
    want, got = scene_tensors(sc5), scene_tensors(res["scene"])
    require(sorted(want) == sorted(got), "scenefile5",
            f"scene fields differ: {sorted(set(want) ^ set(got))}")
    env_err = {}
    for k, a in want.items():
        b = got[k]
        require(a.shape == b.shape and a.dtype == b.dtype, "scenefile5",
                f"{k}: {tuple(b.shape)} {b.dtype} against {tuple(a.shape)} "
                f"{a.dtype}")
        if k in ("env_pmf", "env_cdf"):
            env_err[k] = float((a.double() - b.double()).abs().max())
            require(env_err[k] <= ENV_TABLE_ATOL, "scenefile5",
                    f"{k} differs by {env_err[k]}")
        else:
            require(bool(torch.equal(a, b)), "scenefile5",
                    f"{k} differs from --config 5's")
    img = res["image"]
    mean_rel = abs(float(img.mean()) - float(img5.mean())) / float(
        img5.mean())
    close = float(np.isclose(img, img5, rtol=SCENE5_TOL,
                             atol=SCENE5_TOL).mean())
    rays = W5 * H5 * SPP * DEPTH5 * (1 + shadow_rays_per_bounce(sc5))
    fields = dict(phase="scenefile5", ok=True, file_bytes=file_bytes,
                  write_s=write_s, load_s=res["load_s"],
                  frame_s=res["render_s"],
                  mrays_s=rays / res["render_s"] / 1e6, launches=launches,
                  tensors_equal=len(want) - len(env_err),
                  env_table_max_abs=env_err, env_table_atol=ENV_TABLE_ATOL,
                  mean=float(img.mean()), main5_mean=float(img5.mean()),
                  mean_rel=mean_rel, mean_rtol=SCENE5_MEAN_RTOL,
                  close_frac=close, close_tol=SCENE5_TOL,
                  close_gate=SCENE5_CLOSE,
                  max_abs_diff=float(np.abs(img - img5).max()))
    require(mean_rel <= SCENE5_MEAN_RTOL and close >= SCENE5_CLOSE,
            "scenefile5", json.dumps(fields))
    emit(**fields)


def phase_ladder(sc4, cam4, dev):
    """Ladder config 4 (the scalp model: 300,000 segments) at its spec,
    512x512 and depth 6, through ``progressive_render`` on the first
    LADDER_SPP of the golden's 32 sample streams, launch counts set to 0
    just before and read just after: the mean within GOLDEN_MEAN_RTOL of
    ``goldens/config4_stats.json``. -> the launches."""
    import numpy as np

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.apps import render as app

    cfg = CONFIGS[4]
    with open(os.path.join(GOLDEN, "config4_stats.json")) as f:
        gold = json.load(f)
    zero_launches()
    t0 = time.perf_counter()
    img = app.progressive_render(sc4, cam4, cfg["res"], cfg["res"],
                                 LADDER_SPP, cfg["depth"], seed=0, log=None,
                                 device=dev)
    seconds = time.perf_counter() - t0
    launches = read_launches("ladder")
    mean = float(img.mean())
    mean_rel = abs(mean - gold["mean"]) / gold["mean"]
    fields = dict(phase="ladder", ok=True, config=4, res=cfg["res"],
                  spp=LADDER_SPP, golden_spp=cfg["spp"],
                  cut=f"the first {LADDER_SPP} of the golden's "
                      f"{cfg['spp']} sample streams",
                  depth=cfg["depth"], segments=int(
                      (sc4.accel.seg_index >= 0).sum()),
                  clusters=sc4.accel.n_clusters, seconds=seconds,
                  launches=launches, mean=mean, golden_mean=gold["mean"],
                  mean_rel=mean_rel, mean_rtol=GOLDEN_MEAN_RTOL,
                  p99_lum=float(np.percentile(img.mean(-1), 99)),
                  golden_p99_lum=gold["p99_lum"])
    require(bool(np.isfinite(img).all()) and mean_rel <= GOLDEN_MEAN_RTOL,
            "ladder", json.dumps(fields))
    emit(**fields)
    return launches


class WalkRecorder:
    """Wraps ``accel.traverse.nearest_hit`` for the span of a ``with``:
    each query's rays, lockstep steps, ray steps and wall ms (the walk
    syncs with the host every 16 steps, so a query ends in a sync)."""

    def __init__(self, traverse):
        self.traverse = traverse
        self.queries = []

    def __enter__(self):
        import torch
        tr = self.traverse
        self.orig = tr.nearest_hit
        nearest_hit = self.orig

        def rec(o, d, bvh, *args, **kwargs):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = nearest_hit(o, d, bvh, *args, stats=stats, **kwargs)
            torch.cuda.synchronize()
            self.queries.append(dict(rays=o.shape[0],
                                     ms=(time.perf_counter() - t0) * 1e3,
                                     **stats))
            return out

        tr.nearest_hit = rec
        return self

    def __exit__(self, *exc):
        self.traverse.nearest_hit = self.orig

    def summary(self):
        q = self.queries
        rays = sum(x["rays"] for x in q)
        return dict(queries=len(q), walk_ms=sum(x["ms"] for x in q),
                    ms_per_query=sum(x["ms"] for x in q) / max(len(q), 1),
                    steps_per_query=sum(x["steps"] for x in q)
                    / max(len(q), 1),
                    max_steps=max((x["steps"] for x in q), default=0),
                    ray_steps_per_ray=sum(x["ray_steps"] for x in q)
                    / max(rays, 1))


def phase_bvh(sc, cam, dev):
    """Config 3 through the skip-pointer BVH on the card: (a) strip 0's
    camera rays against the cluster kernel; (b) the bench frame at
    BVH_FRAME_DEPTH against the cluster kernels' (strip 0 only if the
    frame would outlast BVH_FRAME_BUDGET_S)."""
    import numpy as np
    import torch

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.accel import traverse
    from yhair_tpu_torch.apps import common
    from yhair_tpu_torch.core.camera import camera_rays
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    scb, camb = common.build_device_scene(*CONFIGS[3]["fn"](), accel="bvh",
                                          leaf_size=BVH_LEAF, device=dev)
    build_s = time.perf_counter() - t0
    bvh = scb.accel
    require(isinstance(bvh, traverse.DeviceBVH)
            and bvh.p0.device.type == dev.type, "bvh",
            f"accel='bvh' did not build a DeviceBVH on {dev}")

    # (a) strip 0's camera rays: the walk against the cluster kernel
    pid = strip_pixels(WIDTH, HEIGHT, 0, dev)
    u = mesh.ray_uniforms(mesh.key_seed(0), pid, torch.zeros_like(pid),
                          DEPTH)
    o, d = camera_rays(camb, WIDTH, HEIGHT, (pid % WIDTH).to(u.dtype),
                       (pid // WIDTH).to(u.dtype), u[:, :4])
    with WalkRecorder(traverse) as rec_a:
        t_b, _, hit_b, orig_b = traverse.nearest_hit(o, d, bvh)
    t_c, idx_c, hit_c = ik.make_nearest_fn(sc.accel, device=dev)(o, d)
    orig_c = sc.accel.seg_index[idx_c.long()]
    require(torch.equal(hit_b, hit_c), "bvh",
            f"the walk's hits differ from the cluster kernel's on "
            f"{int((hit_b != hit_c).sum())} rays")
    id_frac = float((orig_b[hit_b] == orig_c[hit_b]).float().mean())
    t_rel = float(((t_b - t_c).abs() / t_c.abs())[hit_b].max())
    walk_a = rec_a.summary()
    fields_a = dict(rays=int(o.shape[0]), hits=int(hit_b.sum()),
                    id_frac=id_frac, t_max_rel=t_rel,
                    t_identical=bool(torch.equal(t_b[hit_b], t_c[hit_b])),
                    **walk_a)
    require(id_frac >= BVH_ID_FRAC and t_rel <= BVH_T_RTOL, "bvh",
            json.dumps(fields_a))

    # (b) the frame, strip by strip, against the cluster kernels'
    n_strips = -(-WIDTH * HEIGHT // STRIP)
    ref = torch.as_tensor(common.progressive_render(
        sc, cam, WIDTH, HEIGHT, SPP, BVH_FRAME_DEPTH, seed=0, log=None,
        device=dev).reshape(-1, 3), device=dev)
    diffs, cut = [], None
    t0 = time.perf_counter()
    with WalkRecorder(traverse) as rec_b:
        for b in range(n_strips):
            pid = strip_pixels(WIDTH, HEIGHT, b, dev)
            L = mesh.trace_pixels(scb, camb, WIDTH, HEIGHT, pid,
                                  torch.zeros_like(pid), mesh.key_seed(0),
                                  BVH_FRAME_DEPTH, device=dev)
            diffs.append((L.double() - ref[pid]).abs().reshape(-1))
            elapsed = time.perf_counter() - t0
            if b == 0 and elapsed * n_strips > BVH_FRAME_BUDGET_S:
                cut = (f"strip 0 only: it took {elapsed:.1f} s, so the "
                       f"frame would take about {elapsed * n_strips:.0f} s "
                       f"(budget {BVH_FRAME_BUDGET_S:.0f} s)")
                break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diff = torch.cat(diffs).cpu().numpy()
    fields_b = dict(depth=BVH_FRAME_DEPTH, bench_depth=DEPTH,
                    strips=len(diffs), cut=cut, seconds=seconds,
                    q999=float(np.quantile(diff, 0.999)),
                    mean_abs_diff=float(diff.mean()),
                    identical=bool(diff.max() == 0), **rec_b.summary())
    fields = dict(phase="bvh", ok=True, config=3,
                  segments=int((bvh.seg_index >= 0).sum()),
                  leaf_size=bvh.leaf_size, leaves=bvh.n_leaves,
                  nodes=int(bvh.node_min.shape[0]) - 1, build_s=build_s,
                  check_every=traverse.CHECK_EVERY_CUDA,
                  camera_rays=fields_a, frame=fields_b,
                  gates=dict(t_rel=BVH_T_RTOL, id_frac=BVH_ID_FRAC,
                             q999=BVH_Q999, mean=BVH_MEAN))
    require(fields_b["q999"] < BVH_Q999 and fields_b["mean_abs_diff"]
            < BVH_MEAN, "bvh", json.dumps(fields))
    emit(**fields)


def _rank_worker(rank, world, backend, rdzv, out_dir):
    """One rank of the ``ranks`` phase (a spawned process on cuda:0):
    config 3's bench frame through ``render_fn`` and one
    ``train_step_fn`` step, each with the launch counts set to 0 just
    before and read just after; every all-reduce timed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.parallel import mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{rdzv}", world_size=world, rank=rank,
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    try:
        group, dev = mesh.make_group()
        reduce_ms, wait_ms = [], []
        all_reduce = dist.all_reduce

        def timed_all_reduce(*args, **kwargs):
            # a barrier first, so the all-reduce's ms leave out the wait
            # for the slower rank (kept apart as wait_ms)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier(group=kwargs.get("group"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = all_reduce(*args, **kwargs)
            torch.cuda.synchronize()
            wait_ms.append((t1 - t0) * 1e3)
            reduce_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        dist.all_reduce = timed_all_reduce
        sc, cam, _, _, _ = app.load_config(3, device=dev)
        render = mesh.render_fn(WIDTH, HEIGHT, SPP, DEPTH, group=group,
                                device=dev)
        # a warm-up frame: a process's first frame and first collective
        # set up the kernels' library and the communicator
        render(sc, cam, mesh.key_seed(0))
        reduce_ms.clear()
        wait_ms.clear()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(sc, cam, mesh.key_seed(0))
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        launches = cluster_launches()
        render_reduce_ms, render_wait_ms = list(reduce_ms), list(wait_ms)
        np.save(os.path.join(out_dir, f"img_w{world}_r{rank}.npy"),
                img.cpu().numpy())

        target = torch.as_tensor(np.load(os.path.join(out_dir,
                                                      "target.npy")),
                                 device=dev)
        step = mesh.train_step_fn(WIDTH, HEIGHT, SPP, DEPTH,
                                  pixel_batch=STRIP, group=group,
                                  device=dev)
        train = []
        for _ in range(2 if world == 1 else 1):   # world 1: run to run
            scp, params = trainable(sc)
            with torch.no_grad():
                for p in params.values():
                    p.mul_(RANKS_START)
            opt = torch.optim.Adam(params.values(), lr=RANKS_LR)
            reduce_ms.clear()
            wait_ms.clear()
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = step(params, opt, scp, cam, target,
                               mesh.key_seed(RANKS_SEED),
                               torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            train.append(dict(
                seconds=time.perf_counter() - t0,
                launches=cluster_launches(), reduce_ms=list(reduce_ms),
                wait_ms=list(wait_ms),
                loss=float(loss),
                grads={k: g.cpu().tolist() for k, g in grads.items()},
                params={k: p.detach().cpu().tolist()
                        for k, p in params.items()}))
        with open(os.path.join(out_dir, f"w{world}_r{rank}.json"), "w") as f:
            json.dump(dict(world=world, rank=rank, backend=backend,
                           device=str(dev), frame_s=frame_s,
                           launches=launches,
                           render_reduce_ms=render_reduce_ms,
                           render_wait_ms=render_wait_ms, train=train),
                      f)
    finally:
        dist.destroy_process_group()


def _run_ranks(backend, world, out_dir):
    """Spawn one group of ``world`` ranks; -> each rank's record. Fails
    if a rank fails or outlives RANKS_TIMEOUT_S; kills what is left."""
    import numpy as np
    import torch.multiprocessing as tmp

    rdzv = os.path.join(out_dir, f"rdzv_{backend}_{world}")
    ctx = tmp.start_processes(_rank_worker,
                              args=(world, backend, rdzv, out_dir),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            require(time.monotonic() < deadline, "ranks",
                    f"{backend} world size {world}: a rank hung past "
                    f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"w{world}_r{r}.json")) as f:
            rec = json.load(f)
        rec["image"] = np.load(os.path.join(out_dir,
                                            f"img_w{world}_r{r}.npy"))
        out.append(rec)
    return out


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.abs(b)).max())


def phase_ranks(img3):
    """The multi-rank path (``parallel.mesh.render_fn`` and
    ``train_step_fn`` over a process group) on the one card: world size
    1 over NCCL and 2 over gloo, both ranks on cuda:0. Each frame
    bit-equal to ``main``'s image; the world-size-2 train step's loss and
    gradients against world size 1's; the params equal on every rank."""
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        np.save(os.path.join(out_dir, "target.npy"),
                img3.astype(np.float32))
        runs = {world: _run_ranks(backend, world, out_dir)
                for backend, world in RANKS}
    ranks, checks = [], {}
    for world, recs in runs.items():
        for rec in recs:
            img = rec.pop("image")
            equal = bool(np.array_equal(img.astype(np.float64), img3))
            require(equal, "ranks",
                    f"world {world} rank {rec['rank']}: the frame differs "
                    f"from main's image (max |diff| "
                    f"{float(np.abs(img - img3).max())})")
            for launches in [rec["launches"]] + [t["launches"]
                                                 for t in rec["train"]]:
                require(all(n > 0 for n in launches.values()), "ranks",
                        f"world {world} rank {rec['rank']}: a kernel was "
                        f"not launched: {launches}")
            ranks.append(dict(rec, frame_equal_to_main=equal))
    one = runs[1][0]["train"]
    checks["world1_repeat"] = dict(
        loss_rel=_rel(one[1]["loss"], one[0]["loss"]),
        grad_rel={k: _rel(one[1]["grads"][k], one[0]["grads"][k])
                  for k in TRAIN_PARAMS})
    two = [rec["train"][0] for rec in runs[2]]
    checks["world2_vs_world1"] = dict(
        loss_rel=_rel(two[0]["loss"], one[0]["loss"]),
        grad_rel={k: _rel(two[0]["grads"][k], one[0]["grads"][k])
                  for k in TRAIN_PARAMS},
        params_equal_on_ranks=all(t["params"] == two[0]["params"]
                                  for t in two))
    c = checks["world2_vs_world1"]
    fields = dict(phase="ranks", ok=True, width=WIDTH, height=HEIGHT,
                  spp=SPP, depth=DEPTH, pixel_batch=STRIP,
                  seconds=time.perf_counter() - t0, ranks=ranks,
                  checks=checks, loss_rtol=RANKS_LOSS_RTOL,
                  grad_rtol=RANKS_GRAD_RTOL,
                  four_cards="not run: this machine holds one card, so "
                             "the four-card NCCL path is unmeasured")
    require(c["params_equal_on_ranks"] and c["loss_rel"] <= RANKS_LOSS_RTOL
            and all(v <= RANKS_GRAD_RTOL for v in c["grad_rel"].values()),
            "ranks", json.dumps(fields))
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


def full_feature_scene(dev):
    """The all-features scene of ``__graft_entry__.py:112-160``, built
    without JAX: two posed instances of a 48-strand hair patch (one
    cluster build), a first-class Bezier curve, a textured emissive quad
    (an area light), an environment map, a textured plane and a point
    light. -> (scene, camera) on dev."""
    import numpy as np

    from scenes.generators import hair_patch
    from yhair_tpu_torch.accel.instanced import build_instanced
    from yhair_tpu_torch.core import scene as tscene
    from yhair_tpu_torch.ops import build_scene_clusters

    scene_d, cam_d = hair_patch(n_strands=48, n_seg=3)
    quad = {
        "positions": np.array([[-0.3, 0.45, -0.3], [0.3, 0.45, -0.3],
                               [0.3, 0.45, 0.3], [-0.3, 0.45, 0.3]]),
        "triangles": np.array([[0, 1, 2], [0, 2, 3]], np.int64),
        "texcoords": np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                              np.float64),
        "material": {"emission": [4.0, 3.5, 3.0], "color": [0, 0, 0],
                     "emission_tex": 0},
    }
    checker = np.where((np.indices((4, 4)).sum(0) % 2)[..., None] > 0,
                       np.array([1.0, 0.8, 0.6]), np.array([0.4, 0.5, 0.9]))
    scene_d = dict(
        scene_d, meshes=[quad],
        planes=[{"point": [0, -0.4, 0], "normal": [0, 1, 0],
                 "material": {"color": [0.5, 0.5, 0.5], "color_tex": 1}}],
        textures=[{"data": checker}, {"data": checker[::-1]}],
        env_map=0.05 + 0.1 * np.random.default_rng(3).random((4, 8, 3)),
        curves={"cp": np.array([[[-0.2, -0.1, 0.2], [-0.1, 0.15, 0.2],
                                 [0.1, -0.15, 0.2], [0.2, 0.1, 0.2]]]),
                "r0": np.array([0.01]), "r1": np.array([0.004])})
    sc, cl = build_scene_clusters(tscene.from_dict(scene_d, device=dev),
                                  device=dev)
    frames = [[[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]],
              [[0, 1, 0], [-1, 0, 0], [0, 0, 1], [0.12, 0.0, 0.05]]]
    return (sc._replace(accel=build_instanced(cl, frames, device=dev)),
            tscene.camera_from_dict(cam_d, device=dev))


def instanced_config3(sc, dev):
    """Config 3's clustered scene posed twice (INST_FRAMES, one cluster
    build held once), and the same two wigs baked into one flat soup and
    clustered anew; hair-material row 0 is config 3's, row 1 the same
    with beta_m x 1.6 (``tests/test_instances.py:_baked_scene``).

    The bake flattens the very geometry the instanced path poses (its
    float32 canonical segments through ``gather_world_segments``). A bake
    posed in float64 from the generator's segments differs from it by
    ulps of the coordinates, and depth-4 paths in the dense hairball
    amplify that: 96.2% of the values agree within 5e-3 at 64x64 on the
    CPU, 96.4% at 512x512 on the card, against 99.95% for this bake.
    -> (instanced scene, baked scene)."""
    import numpy as np
    import torch

    from scenes.generators import CONFIGS
    from yhair_tpu_torch.accel.instanced import (build_instanced,
                                                 gather_world_segments)
    from yhair_tpu_torch.core import scene as tscene
    from yhair_tpu_torch.ops import build_scene_clusters

    ic = build_instanced(sc.accel, INST_FRAMES, inst_mat=[0, 1], device=dev)
    real = torch.nonzero(ic.cl.seg_index >= 0)[:, 0]
    n_seg = ic.cl.seg_index.shape[0]
    *posed, mid = gather_world_segments(ic, sc.segments, torch.cat(
        [i * n_seg + real for i in range(ic.n_instances)]))
    scene_d, _ = CONFIGS[3]["fn"]()
    m = scene_d["hair_material"]
    baked = dict(scene_d, segments=tuple(a.cpu().numpy() for a in posed),
                 hair_materials=[m, dict(m, beta_m=min(0.9,
                                                       m["beta_m"] * 1.6))],
                 segment_mat_id=mid.cpu().numpy())
    sc_baked, _ = build_scene_clusters(tscene.from_dict(baked, device=dev),
                                       device=dev)
    return sc._replace(hair=sc_baked.hair, accel=ic), sc_baked


class SkipCounter:
    """Counts, for the span of a ``with``, the instance box tests of the
    instanced searches (each ends in one host sync: does any ray touch
    the box?) and the instance searches that ran (cluster lists and
    kernels); the difference is the instances skipped."""

    def __enter__(self):
        from yhair_tpu_torch.accel import instanced
        from yhair_tpu_torch.ops import intersect_kernel as ik
        self.mods = [(instanced, "_box_interval"), (ik, "nearest_hit"),
                     (ik, "any_hit")]
        self.orig = [getattr(m, n) for m, n in self.mods]
        self.calls = [0, 0, 0]

        def counting(i, fn):
            def run(*a, **kw):
                self.calls[i] += 1
                return fn(*a, **kw)
            return run
        for i, ((m, n), fn) in enumerate(zip(self.mods, self.orig)):
            setattr(m, n, counting(i, fn))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.mods, self.orig):
            setattr(m, n, fn)

    def fields(self):
        box, near, anyh = self.calls
        return dict(instance_box_tests=box, host_syncs=box,
                    instance_searches=near + anyh,
                    instances_skipped=box - near - anyh)


def phase_inst3(sc, cam, dev):
    """Config 3 posed as two instances with two hair materials: the
    kernels on the centre strip (every launch bit-equal to its plain
    version, in each instance's frame), the forward frame against the
    baked scene's, and one forward+backward frame into the two-row
    table. -> (hit stats, any stats, lists stats, launches of the
    instanced frame)."""
    import numpy as np
    import torch

    t0 = time.time()
    sc_inst, sc_baked = instanced_config3(sc, dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    ic = sc_inst.accel
    hit_i, any_i, lists_i = phase_kernels(
        sc_inst, cam, dev, strip=WIDTH * HEIGHT // STRIP // 2,
        phase="kernels_inst3")
    with SkipCounter() as skips:
        launches, img_i, inst = phase_main(sc_inst, cam, dev,
                                           phase="inst3", emit_line=False)
    launches_b, img_b, baked = phase_main(sc_baked, cam, dev, phase="inst3",
                                          emit_line=False)
    close = np.isclose(img_i, img_b, rtol=INST_TOL, atol=INST_TOL)
    require(close.mean() >= INST_CLOSE, "inst3",
            f"instanced frame against baked: only {close.mean():.4f} of the "
            f"values within {INST_TOL}")
    fwdbwd = bench_fwdbwd(sc_inst, cam, dev, warm_up=False, phase="inst3")
    emit(phase="inst3", ok=True, instances=ic.n_instances,
         canonical_segments=int((ic.cl.seg_index >= 0).sum()),
         clusters=ic.cl.n_clusters, tile_bytes=nbytes(ic.cl.tc),
         baked_clusters=sc_baked.accel.n_clusters,
         baked_tile_bytes=nbytes(sc_baked.accel.tc), build_s=build_s,
         hair_materials={k: v.tolist() for k, v in
                         sc_inst.hair._asdict().items()},
         instanced=dict(inst, **skips.fields()), baked=baked,
         close_frac=float(close.mean()), close_tol=INST_TOL,
         close_gate=INST_CLOSE,
         max_abs_diff=float(np.abs(img_i - img_b).max()), **fwdbwd)
    return hit_i, any_i, lists_i, launches


def soft_gradient_check(sc, cam, dev, width=WIDTH, height=HEIGHT,
                        window=SOFT_WINDOW, depth=SOFT_DEPTH, soft=SOFT,
                        rtol=SOFT_RTOL, phase="soft3"):
    """With soft silhouettes, d mean(L) / d radius scale and / d the p0
    of the segment the card's gradient moves most, on the centre window's
    rays, on the card (both kernels) against the same rays, scene and
    uniforms on the CPU (the kernels' plain versions): finite, non-zero,
    within rtol (the p0 row by its vector norm)."""
    import torch

    from yhair_tpu_torch.parallel import mesh

    pix = centre_pixels(width, height, window)

    def grads(scene, device):
        s = torch.ones((), device=device, requires_grad=True)
        p0 = scene.segments.p0.detach().clone().requires_grad_(True)
        segs = scene.segments._replace(p0=p0, r0=scene.segments.r0 * s,
                                       r1=scene.segments.r1 * s)
        pid = torch.as_tensor(pix, device=device)
        L = mesh.trace_pixels(scene._replace(segments=segs), cam.to(device),
                              width, height, pid, torch.zeros_like(pid),
                              mesh.key_seed(0), depth, edge_softness=soft,
                              device=device)
        L.double().mean().backward()
        return float(s.grad), p0.grad.cpu()

    s_card, p0_card = grads(sc, dev)
    s_cpu, p0_cpu = grads(sc.to("cpu"), torch.device("cpu"))
    row = int(p0_card.norm(dim=-1).argmax())
    a, b = p0_card[row], p0_cpu[row]
    out = dict(radius_scale=dict(card=s_card, cpu=s_cpu,
                                 rel_err=abs(s_card - s_cpu) / max(
                                     abs(s_cpu), 1e-30)),
               p0=dict(segment=row, card=a.tolist(), cpu=b.tolist(),
                       rel_err=float((a - b).norm() / max(float(b.norm()),
                                                          1e-30))))
    for k, v in out.items():
        require(v["rel_err"] <= rtol and bool(torch.isfinite(
            torch.tensor(v["card"])).all()) and torch.tensor(
            v["cpu"]).abs().max() > 0, phase,
            f"card-against-CPU soft-edge gradient of {k}: {v}")
    return out


def phase_soft3(sc, cam, dev):
    """Config 3 with soft silhouettes: the card-against-CPU geometry
    gradients and three ``invert --edge-softness`` steps."""
    fields = dict(gradient_check=soft_gradient_check(sc, cam, dev))
    fields.update(invert_steps(dev, (
        "--config", "3", "--resolution", str(WIDTH), "--spp", str(SPP),
        "--bounces", str(DEPTH), "--steps", "3", "--pixel-batch", str(STRIP),
        "--edge-softness", str(SOFT)), phase="soft3"))
    emit(phase="soft3", ok=True, edge_softness=SOFT, grad_window=SOFT_WINDOW,
         grad_depth=SOFT_DEPTH, grad_rtol=SOFT_RTOL, **fields)


# the control-point inverse of tests/test_curves.py:130-196
CURVE_CAM = {"position": [0.0, 0.0, 2.2], "look_at": [0.0, 0.0, 0.0],
             "up": [0.0, 1.0, 0.0], "vfov_deg": 35.0}
CURVE_STEPS, CURVE_LR, CURVE_SOFT = 100, 4e-3, 0.3


def _curve_scene(seed=3):
    """``tests/test_curves.py``'s one random curve (1.6x its radii) over
    a plane under a point light."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cp = rng.normal(size=(1, 1, 3)) * 0.1 + np.cumsum(
        rng.normal(size=(1, 4, 3)) * 0.15, axis=1)
    cp -= cp.mean(axis=(0, 1))
    return {"hair_material": {"sigma_a": np.array([0.06, 0.1, 0.2]),
                              "beta_m": 0.3, "beta_n": 0.35},
            "planes": [{"point": [0, 0, -1.0], "normal": [0, 0, 1.0],
                        "albedo": [0.4, 0.35, 0.3]}],
            "point_lights": [{"position": [1.5, 1.5, 2.5],
                              "intensity": [14.0, 14.0, 14.0]}],
            "environment": np.array([0.02, 0.02, 0.03]),
            "curves": {"cp": cp, "r0": np.full(1, 0.048),
                       "r1": np.full(1, 0.024)}}


def curve_inverse(dev, steps=CURVE_STEPS):
    """Recover a rigid shift of the curve's control points by Adam
    through the full render (32x32, 2 spp, depth 2, soft silhouettes),
    the target rendered on the same uniforms. -> (losses, err, err0)."""
    import numpy as np
    import torch

    from yhair_tpu_torch.core import scene as tscene
    from yhair_tpu_torch.core.rng import n_uniform_dims
    from yhair_tpu_torch.integrator import path

    sc = tscene.from_dict(_curve_scene(), device=dev)
    cam = tscene.camera_from_dict(CURVE_CAM, device=dev)
    u = torch.as_tensor(np.random.default_rng(0).random(
        (32, 32, 2, n_uniform_dims(2))).astype(np.float32), device=dev)

    def render(cp):
        return path.render(sc._replace(crv_cp=cp), cam, u, max_depth=2,
                           chunk=512, edge_softness=CURVE_SOFT, device=dev)

    with torch.no_grad():
        target = render(sc.crv_cp)
    shift = torch.tensor([0.03, -0.02, 0.0], device=dev)
    delta = torch.zeros(3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=CURVE_LR)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = ((render(sc.crv_cp + shift - delta) - target) ** 2).mean()
        loss.backward()
        delta.grad = torch.where(torch.isfinite(delta.grad), delta.grad, 0.0)
        opt.step()
        losses.append(loss.item())
    return (losses, float((delta.detach() - shift).norm()),
            float(shift.norm()))


def phase_curves(dev):
    """Config 1's strand as one first-class curve against the same strand
    tessellated into 2^CURVE_DEPTH segments (config 1's spec, the
    reference's gate), then the control-point inverse."""
    import numpy as np

    from scenes.generators import CONFIGS, _strands_to_segments
    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.core import scene as tscene
    from yhair_tpu_torch.integrator import path
    from yhair_tpu_torch.ops import build_scene_clusters

    cfg = CONFIGS[1]
    scene_d, cam_d = cfg["fn"]()
    cp = np.array([[[0.0, -0.5, 0.0], [0.25, -0.1, 0.1],
                    [-0.2, 0.3, -0.05], [0.1, 0.6, 0.0]]])
    r0, r1 = np.array([0.02]), np.array([0.008])
    crv = dict(scene_d, curves={"cp": cp, "r0": r0, "r1": r1})
    crv.pop("segments")
    tes = dict(scene_d, segments=_strands_to_segments(
        cp, r0, r1, n_seg=1 << path.CURVE_DEPTH))
    cam = tscene.camera_from_dict(cam_d, device=dev)
    imgs, seconds = {}, {}
    for name, d in (("curve", crv), ("tessellated", tes)):
        sc, _ = build_scene_clusters(tscene.from_dict(d, device=dev),
                                     device=dev)
        zero_launches()
        t0 = time.perf_counter()
        imgs[name] = app.progressive_render(sc, cam, cfg["res"], cfg["res"],
                                            cfg["spp"], cfg["depth"], seed=0,
                                            log=None, device=dev)
        seconds[name] = time.perf_counter() - t0
    diff = np.abs(imgs["curve"] - imgs["tessellated"]).max(-1)
    close = float((diff < 1e-2).mean())
    require(bool(np.isfinite(imgs["curve"]).all()) and close > 0.995,
            "curves", f"curve against tessellated: {close:.4f} of the "
                      f"pixels within 1e-2")
    t0 = time.perf_counter()
    losses, err, err0 = curve_inverse(dev)
    inverse_s = time.perf_counter() - t0
    ok = (all(np.isfinite(losses)) and losses[-1] < 0.6 * losses[0]
          and err < 0.8 * err0)
    fields = dict(phase="curves", ok=ok, res=cfg["res"], spp=cfg["spp"],
                  depth=cfg["depth"], render_seconds=seconds,
                  close_frac=close, mean_abs_diff=float(diff.mean()),
                  image_mean=float(imgs["curve"].mean()),
                  inverse_steps=len(losses), inverse_seconds=inverse_s,
                  first_loss=losses[0], last_loss=losses[-1], err=err,
                  err0=err0)
    require(ok, "curves", json.dumps(fields))
    emit(**fields)


FULL_RES, FULL_SPP, FULL_DEPTH, FULL_SOFT, FULL_RTOL = 16, 2, 2, 0.2, 1e-2


def phase_full(dev):
    """One ``train_step_fn`` step on the all-features scene on the card
    and on the CPU from the same params and target: finite, the card's
    loss and gradients within FULL_RTOL of the CPU's."""
    import numpy as np
    import torch

    from yhair_tpu_torch import convert
    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.parallel import mesh

    start = {"beta_m": np.float32(0.5), "beta_n": np.float32(0.5),
             "sigma_a": np.full(3, 0.2, np.float32)}
    sc, cam = full_feature_scene(dev)
    target = torch.as_tensor(np.float32(app.progressive_render(
        sc, cam, FULL_RES, FULL_RES, FULL_SPP, FULL_DEPTH, seed=0,
        edge_softness=FULL_SOFT, log=None, device=dev)))
    out = {}
    for name, device, scene, camera in (
            ("card", dev, sc, cam),
            ("cpu", torch.device("cpu"), sc.to("cpu"), cam.to("cpu"))):
        params = convert.params_from_numpy(start, device=device)
        step = mesh.train_step_fn(FULL_RES, FULL_RES, FULL_SPP,
                                  max_depth=FULL_DEPTH,
                                  edge_softness=FULL_SOFT, device=device)
        t0 = time.perf_counter()
        loss, grads = step(params, torch.optim.Adam(params.values(), lr=1e-2),
                           scene, camera, target, mesh.key_seed(1))
        out[name] = dict(loss=float(loss), seconds=time.perf_counter() - t0,
                         grads={k: g.cpu().reshape(-1).tolist()
                                for k, g in grads.items()})
    card, cpu = out["card"], out["cpu"]
    vals = [(card["loss"], cpu["loss"])] + [
        (a, b) for k in start for a, b in zip(card["grads"][k],
                                              cpu["grads"][k])]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in vals)
    ok = all(np.isfinite(a) and b != 0 for a, b in vals) and rel <= FULL_RTOL
    fields = dict(phase="full", ok=ok, res=FULL_RES, spp=FULL_SPP,
                  depth=FULL_DEPTH, edge_softness=FULL_SOFT,
                  instances=sc.accel.n_instances, curves=sc.n_curves,
                  area_lights=sc.n_area_lights, textures=int(
                      sc.tex_meta.shape[0]), env_map=list(
                      sc.env_map.shape[:2]), card=card, cpu=cpu,
                  max_rel_err=rel, rtol=FULL_RTOL)
    require(ok, "full", json.dumps(fields))
    emit(**fields)


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


def phase_scene4(dev):
    """Config 4 at its full size: the scene, its clusters and camera."""
    import torch

    from yhair_tpu_torch.apps import render as app

    t0 = time.time()
    sc, cam, _, _, _ = app.load_config(4, device=dev)
    torch.cuda.synchronize()
    cl = sc.accel
    real = (cl.seg_index >= 0).reshape(cl.n_clusters, -1)
    emit(phase="scene4", ok=True, segments=int(real.sum()),
         clusters=cl.n_clusters, nonempty_clusters=int(real.any(1).sum()),
         tile_bytes=nbytes(cl.tc), spheres=sc.n_spheres,
         point_lights=sc.n_lights,
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
    return img


def phase_invert5spec(sc5, img5, dev):
    """Config 5's inverse at spec (1024x1024, 64 spp, depth 6,
    2,048-pixel batches; ``ladder_gpu.py`` runs its 120 steps) through
    the ``invert`` CLI on golden5's image as the target. (a) Three steps
    in one run, launch counts set to 0 just before and read just after;
    then two steps, a checkpoint and one resumed step: params, gradients
    and losses bit-equal. (b) Losses and gradients finite, every param
    moved. (c) The resumed step's launches recorded, the first list
    build, hit and any launch held against their plain versions
    (bit-equal). (d) Seconds per step. sc5 is config 5 as ``scene5``
    built it (the CLI builds its own). -> (hit stats, any stats, lists
    stats, launches)."""
    import tempfile

    import numpy as np

    from ladder_gpu import step_seconds
    from yhair_tpu_torch.apps import invert
    from yhair_tpu_torch.io import image as img_io
    from yhair_tpu_torch.ops import intersect_kernel as ik

    phase = "invert5spec"
    with tempfile.TemporaryDirectory() as tmp:
        target, ck = (os.path.join(tmp, "target.pfm"),
                      os.path.join(tmp, "invert.ckpt"))
        img_io.save_pfm(target, img5)
        argv = ["--config", "5", "--resolution", str(W5), "--spp",
                str(SPEC5_SPP), "--bounces", str(DEPTH5), "--pixel-batch",
                str(INVERT5_BATCH), "--target", target]
        zero_launches()
        with step_seconds() as seconds:
            whole = invert_steps(dev, (*argv, "--steps", "3"), phase=phase)
        launches = read_launches(phase)
        every = invert.CHECKPOINT_EVERY
        invert.CHECKPOINT_EVERY = 2
        try:
            quiet(invert.main, [*argv, "--steps", "2", "--checkpoint", ck,
                                "--out", os.path.join(tmp, "a.json"),
                                "--device", str(dev)])
        finally:
            invert.CHECKPOINT_EVERY = every
        with Recorder(ik) as rec:
            resumed, _ = quiet(invert.main, [
                *argv, "--steps", "3", "--checkpoint", ck, "--out",
                os.path.join(tmp, "b.json"), "--device", str(dev)])
    for key in ("recovered", "losses", "final_grads"):
        require(resumed[key] == whole[f"invert_{key}"], phase,
                f"the resumed run's {key} differ from the uninterrupted "
                f"run's: {resumed[key]} against {whole[f'invert_{key}']}")
    require(bool(np.isfinite(whole["invert_losses"]).all()), phase,
            f"a loss is not finite: {whole['invert_losses']}")
    require(len(rec.hit) > 0 and len(rec.any) > 0, phase,
            f"the resumed step launched {len(rec.hit)} hit and "
            f"{len(rec.any)} any kernels")
    c = sc5.accel.n_clusters
    hit_st, any_st, lists_st, kinds = (new_stats(1), new_stats(1),
                                       new_stats(1), {})
    hold_lists(lists_st, *rec.lists[0], phase)
    hold_hit(hit_st, kinds, *rec.hit[0], c, phase)
    hold_any(any_st, kinds, *rec.any[0], c, phase)
    for st in (hit_st, any_st, lists_st):
        per_launch(st)
    emit(phase=phase, ok=True, width=W5, height=H5, spp=SPEC5_SPP,
         depth=DEPTH5, pixel_batch=INVERT5_BATCH,
         launches=launches,
         step_launches={"lists_kernel": len(rec.lists),
                        "hit_kernel": len(rec.hit),
                        "any_kernel": len(rec.any)},
         resume="bit-equal params, gradients and losses",
         kernel_vs_plain="bit-equal", step_seconds=seconds,
         per_launch_ms=launch_ms(hit_st, any_st, lists_st),
         lists=summarize_kinds(kinds), **whole)
    return hit_st, any_st, lists_st, launches


def kernel_record(name, replaces, st, launches, path,
                  source="yhair_tpu_torch/csrc/intersect.cu"):
    return {"name": name, "path": path, "route": "cuda",
            "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stop-after", choices=("build", "kernels", "main"),
                   help="end after this phase, printing no result")
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
    _, ptxas = phase_build()
    if args.stop_after == "build":
        return 0

    from yhair_tpu_torch.apps import render as app
    dev = torch.device("cuda")
    t0 = time.time()
    sc, cam, _, _, _ = app.load_config(3, device=dev)
    emit(phase="scene", ok=True, segments=int(sc.segments.p0.shape[0]),
         clusters=sc.accel.n_clusters, lights=sc.n_lights,
         seconds=time.time() - t0)
    hit_stats, any_stats, lists_stats = phase_kernels(sc, cam, dev)
    hair3 = phase_hair(sc, cam, dev, ptxas)
    if args.stop_after == "kernels":
        return 0
    launches, img3, _ = phase_main(sc, cam, dev)
    if args.stop_after == "main":
        return 0
    train_losses = phase_train(sc, cam, dev)
    phase_golden(sc, cam, dev)
    phase_scenefile3(img3, train_losses, dev)
    hit_i, any_i, lists_i, launches_i = phase_inst3(sc, cam, dev)
    phase_soft3(sc, cam, dev)
    phase_curves(dev)
    phase_full(dev)

    sc5, cam5 = phase_scene5(dev)
    strip5 = W5 * H5 // STRIP // 2      # the strip through the centre
    hit5, any5, lists5 = phase_kernels(sc5, cam5, dev, W5, H5, DEPTH5,
                                       strip5, phase="kernels5")
    hair5 = phase_hair(sc5, cam5, dev, ptxas, W5, H5, DEPTH5, strip5,
                       phase="hair5")
    tri_hit5, tri_any5 = phase_triangles(sc5, cam5, dev, W5, H5, DEPTH5,
                                         strip5)
    launches5, img5, _ = phase_main(sc5, cam5, dev, W5, H5, DEPTH5,
                                    phase="main5")
    phase_train5(sc5, cam5, dev)
    img5_golden = phase_golden5(sc5, cam5, dev)
    hit5i, any5i, lists5i, launches5i = phase_invert5spec(
        sc5, img5_golden, dev)
    del img5_golden
    phase_scenefile5(sc5, img5, dev)
    del sc5, cam5, img5

    sc4, cam4 = phase_scene4(dev)
    hit4, any4, lists4 = phase_kernels(sc4, cam4, dev, W4, H4, DEPTH4,
                                       W4 * H4 // STRIP // 2,
                                       phase="kernels4")
    launches4 = phase_ladder(sc4, cam4, dev)
    del sc4, cam4
    phase_bvh(sc, cam, dev)
    phase_ranks(img3)
    emit(phase="total", ok=True, seconds=time.time() - t_start)

    records = []
    for suffix, path, lc, stats in (
            ("", "config 3, bench.py workload", launches,
             (hit_stats, any_stats, lists_stats)),
            (" (config 5)", "config 5, furry bunny", launches5,
             (hit5, any5, lists5)),
            (" (instanced)", "config 3 posed as two instances", launches_i,
             (hit_i, any_i, lists_i)),
            (" (config 4)", "config 4, scalp model (ladder)", launches4,
             (hit4, any4, lists4)),
            (" (config 5 inverse step)",
             "config 5 inverse at spec, 3 invert steps", launches5i,
             (hit5i, any5i, lists5i))):
        records += [
            kernel_record("lists_kernel" + suffix,
                          "none (yhair_tpu/ops/intersect_kernel.py:52 "
                          "_block_cluster_lists is jnp, fused by XLA)",
                          stats[2], lc["lists_kernel"], path),
            kernel_record("hit_kernel" + suffix,
                          "yhair_tpu/ops/intersect_kernel.py:186", stats[0],
                          lc["hit_kernel"], path),
            kernel_record("any_kernel" + suffix,
                          "yhair_tpu/ops/intersect_kernel.py:316", stats[1],
                          lc["any_kernel"], path)]
    records += [
        kernel_record(name + " (config 5)",
                      f"none (yhair_tpu/geometry/triangles.py:{fn} is jnp "
                      "left to XLA)", st, launches5[name],
                      "config 5, furry bunny")
        for name, fn, st in (
                ("tri_hit_kernel", "135 nearest_hit", tri_hit5),
                ("tri_any_kernel", "171 occluded", tri_any5))]
    records += [
        kernel_record("hair_kernel" + suffix,
                      "none (yhair_tpu/bsdf/hair.py is jnp fused by XLA)",
                      st, lc["hair_kernel"], path,
                      source="yhair_tpu_torch/csrc/hair.cu")
        for suffix, path, lc, st in (
                ("", "config 3, bench.py workload", launches, hair3),
                (" (config 5)", "config 5, furry bunny", launches5, hair5))]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
