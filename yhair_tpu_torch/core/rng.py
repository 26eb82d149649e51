"""Uniforms layout shared with the oracle and ``yhair_tpu``.

The integrator consumes a flat uniforms tensor: 2 pixel-jitter + 2 lens
dims, then 12 dims per bounce (4 BSDF, 1 RR, 1 light select, 2 env NEE,
2 area-light NEE, 2 reserved). The generator itself is the counter hash
in ``parallel/mesh.py``.
"""

D_PIXEL = 4
D_BOUNCE = 12


def n_uniform_dims(max_depth: int) -> int:
    return D_PIXEL + D_BOUNCE * max_depth
