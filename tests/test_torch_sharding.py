"""Port vs reference: rendering and training over ranks
(``parallel/mesh.py``: ``render_fn`` and ``train_step_fn`` with a
process group).

The torch side runs in worker processes (``torch.multiprocessing``
spawn, the gloo backend on the CPU, a ``file://`` rendezvous under
``tmp_path``), one group per world size, all started together; each
test gives its workers 120 s and fails when one hangs. The JAX side
runs here, on conftest's virtual CPU devices.

- The 80-strand hairball through the BVH at 32x32, 2 spp, depth 3
  renders bit-identically at world sizes 1, 2 and 4 (each ray has one
  nonzero contributor in the all-reduce). Against the reference's
  unsharded ``render_fn``: the gates of ``tests/test_sharding.py:50-52``.
- One train step (16x16, 2 spp, depth 2) on beta_m and sigma_a at world
  sizes 1, 2 and 4: the params equal on every rank; the loss within
  1e-6 and the gradients within 1e-5 relative of world size 1 (see
  GRAD_RTOL). Against the reference's
  ``train_step_fn(mesh=make_mesh(devices[:2]))`` with the same Adam and
  target, whose jitted walk and shading contract FMAs
  (``test_torch_render.py``) and so move single paths: the loss within
  1e-4 (measured 4.7e-6), the gradients within 1e-3 (measured 1.0e-4 on
  the cancelling beta_m, 4.6e-5 on sigma_a) and the new params within
  1e-6 (measured 1.8e-7: Adam's first step is nearly lr * sign(g)).
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from scenes import generators as gen
from yhair_tpu_torch.accel import build_scene_bvh
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.parallel import mesh

# JAX and the reference are imported where the tests use them, not
# here: every spawned worker imports this module again, and needs neither

WORKER_TIMEOUT_S = 120
RENDER = dict(width=32, height=32, spp=2, max_depth=3)
TRAIN = dict(width=16, height=16, spp=2, max_depth=2)
SEED, TRAIN_SEED, LR = 7, 1, 1e-2
START = {"beta_m": 0.45, "sigma_a": [0.3, 0.3, 0.3]}
# across world sizes: a rank sums its own rays' terms in float32, so only
# the order of the sums moves. The loss is a sum of squares; beta_m's
# gradient is a sum whose terms cancel, which magnifies the reordering
# (measured 6.0e-6 relative at world size 2 and 2.5e-6 at 4; sigma_a's
# 1.2e-7, the loss's 6e-8)
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5


def _scene(device="cpu"):
    scene_d, cam_d = gen.curly_hairball(n_strands=80, n_seg=6)
    sc, _ = build_scene_bvh(tscene.from_dict(scene_d, device=device),
                            device=device)
    return sc, tscene.camera_from_dict(cam_d, device=device)


def _worker(rank, world, init_file, out_dir, task):
    """One rank: renders (task "render") or takes one train step (task
    "train", against the target in out_dir) through its share, and saves
    what it got."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        group, dev = mesh.make_group(device="cpu")
        sc, cam = _scene()
        if task == "render":
            img = mesh.render_fn(**RENDER, group=group, device=dev)(
                sc, cam, mesh.key_seed(SEED))
            out = {"image": img}
        else:
            target = torch.as_tensor(np.load(os.path.join(out_dir,
                                                          "target.npy")))
            params = {k: torch.tensor(v, requires_grad=True)
                      for k, v in START.items()}
            opt = torch.optim.Adam(params.values(), lr=LR)
            step = mesh.train_step_fn(**TRAIN, group=group, device=dev)
            loss, grads = step(params, opt, sc, cam, target,
                               mesh.key_seed(TRAIN_SEED))
            out = {"loss": loss, **{f"grad_{k}": g for k, g in
                                    grads.items()},
                   **{f"param_{k}": p.detach() for k, p in params.items()}}
        torch.save(out, os.path.join(out_dir, f"w{world}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_worlds(tmp_path, task, worlds):
    """Start one group per world size together; -> {world: [each rank's
    saved dict]}. Fails if a worker fails or outlives the timeout."""
    ctx = {}
    for w in worlds:
        init = tmp_path / f"{task}_rdzv_{w}"
        ctx[w] = tmp.start_processes(
            _worker, args=(w, str(init), str(tmp_path), task), nprocs=w,
            join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for w, c in ctx.items():
            while not c.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    pytest.fail(f"world size {w}: a worker hung past "
                                f"{WORKER_TIMEOUT_S} s")
    finally:
        for c in ctx.values():
            for p in c.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    return {w: [torch.load(tmp_path / f"w{w}_r{r}.pt") for r in range(w)]
            for w in worlds}


@pytest.fixture(scope="module")
def reference():
    import jax
    from yhair_tpu.accel import build_scene_bvh as jbuild_scene_bvh
    from yhair_tpu.core import scene as jscene
    from yhair_tpu.parallel import mesh as jmesh

    scene_d, cam_d = gen.curly_hairball(n_strands=80, n_seg=6)
    sc, _, nearest = jbuild_scene_bvh(jscene.from_dict(scene_d))
    return jax, jmesh, sc, jscene.camera_from_dict(cam_d), nearest


def test_render_bit_identical_across_world_sizes(tmp_path, reference):
    got = _run_worlds(tmp_path, "render", (1, 2, 4))
    img1 = got[1][0]["image"].numpy()
    for w, outs in got.items():
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out["image"].numpy(), img1,
                                          err_msg=f"world {w} rank {r}")
    jax, jmesh, sc, cam, nearest = reference
    want = np.asarray(jmesh.render_fn(**RENDER, nearest_segments=nearest)(
        sc, cam, jax.random.key(SEED)))
    diff = np.abs(img1 - want)
    assert np.isfinite(img1).all() and img1.std() > 1e-3
    assert np.quantile(diff, 0.999) < 5e-4
    assert diff.mean() < 5e-5


def test_train_step_across_world_sizes(tmp_path, reference):
    """Every world size, and the reference, step against the reference's
    render of the true params."""
    import jax.numpy as jnp
    import optax

    jax, jmesh, sc, cam, nearest = reference
    target = np.asarray(jmesh.render_fn(**TRAIN, nearest_segments=nearest)(
        sc, cam, jax.random.key(0)))
    np.save(tmp_path / "target.npy", target)
    got = _run_worlds(tmp_path, "train", (1, 2, 4))
    one = got[1][0]
    for w, outs in got.items():
        for r, out in enumerate(outs):
            for k, v in out.items():
                if k.startswith("param_"):
                    # every rank stepped the same all-reduced gradient
                    assert torch.equal(v, outs[0][k]), (w, r, k)
                else:
                    np.testing.assert_allclose(
                        v.numpy(), one[k].numpy(),
                        rtol=LOSS_RTOL if k == "loss" else GRAD_RTOL,
                        err_msg=f"{w} {r} {k}")
    assert float(one["param_beta_m"]) != START["beta_m"]

    opt = optax.adam(LR)
    step = jmesh.train_step_fn(**TRAIN, nearest_segments=nearest,
                               mesh=jmesh.make_mesh(jax.devices()[:2]),
                               optimizer=opt)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in START.items()}
    params2, _, loss, grads = jax.jit(step)(
        params, opt.init(params), sc, cam, jnp.asarray(target),
        jax.random.key(TRAIN_SEED))
    np.testing.assert_allclose(float(one["loss"]), float(loss), rtol=1e-4)
    for k in START:
        np.testing.assert_allclose(one[f"grad_{k}"].numpy(),
                                   np.asarray(grads[k]), rtol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(one[f"param_{k}"].numpy(),
                                   np.asarray(params2[k]), rtol=1e-6,
                                   err_msg=k)


def test_shares_must_divide(monkeypatch):
    """Like the reference's mesh, a ray count (render) or pixel count
    (training) that does not divide over the ranks raises; a stand-in
    group of 3 ranks."""
    group = object()
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda g: 3)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda g: 0)
    with pytest.raises(ValueError, match="divide"):
        mesh.render_fn(16, 16, 2, group=group, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mesh.train_step_fn(16, 16, 2, group=group, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mesh.train_step_fn(32, 16, 2, pixel_batch=256, group=group,
                           device="cpu")
    mesh.render_fn(24, 16, 1, group=group, device="cpu")    # 384 rays
    mesh.train_step_fn(24, 16, 1, group=group, device="cpu")
