"""yhair_tpu_torch — the hair path tracer in PyTorch, for NVIDIA Hopper.

A second implementation of ``yhair_tpu`` beside it: the same modules under
the same names, written with torch tensors, and the TPU's Pallas cluster
kernels replaced by CUDA kernels written by hand for ``sm_90a``
(``csrc/intersect.cu``; ``csrc/hair.cu``: the hair BSDF of a bounce). ``yhair_tpu`` stays the reference; the tests in
``tests/test_torch_*.py`` hold each module of this package against it.

It renders and differentiates scenes of hair segments (one material or
a per-shape table of them, posed instances), Bezier curves, spheres,
planes, triangle meshes, point and area lights, a constant environment
or an environment map, and textures (the ladder's configs 1-5), through
the cluster search, the skip-pointer BVH or by brute force, on one card
or over the ranks of a ``torch.distributed`` group. Scenes come from the ladder's
generators or from scene files (JSON beside PLY, .hair, OBJ and image
files).

Layer map:
  kernels.py   the CUDA library: build, the table of its C entry points,
               ``launch`` (the one ``LAUNCHES`` count) and input checks
  io/          scene files, PLY, .hair, OBJ, images (PNG, PFM, EXR, HDR),
               host numpy
  core/        RNG layout, camera, scene tensors, environment map, textures
  geometry/    ray-segment closest approach, the brute-force scan,
               ray-triangle search (``tri_hit_kernel``, ``tri_any_kernel``
               + the plain twin), Bezier curves, mesh shape ops (numpy)
  accel/       LBVH build (host numpy), the native C++ cluster builder
               (ctypes), the skip-pointer BVH walk, posed instances; the
               backend seam ``scene.accel`` (see ``accel/__init__.py``)
  ops/         clusters, the cluster search's three CUDA kernels
               (``lists_kernel``, ``hit_kernel`` + ``hit_merge_kernel``,
               ``any_kernel``) + plain twins
  bsdf/        hair and surface BSDFs; a bounce's hair BSDF in one
               ``hair_kernel`` launch on gradient-free passes + the twin
  integrator/  wavefront path tracer, through ``scene.accel`` alone
  parallel/    counter-hash uniforms, the tile pixel order, rendering and
               training steps over process-group ranks
  utils/       render and training checkpoints, NaN and finite checks,
               the spans and lane counters (trace.py, off by default)
  apps/        the render, invert, convert and view CLIs and the
               progressive renderer they share (apps/common.py)

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without ``device="cpu"`` they raise.
"""

__version__ = "0.1.0"
