"""Micro-FE (FE²) engine — only the micro geometry is ported so far.

``make_engine``'s "auto" route needs ``material2_mask`` to decide whether
the RVE is heterogeneous; the batched micro-FE homogenization itself is
still to be ported (ROADMAP.md, queue 1)."""

from __future__ import annotations

import numpy as np

from macroc_tpu.config import (
    MIC_CILI_FIB_XZ,
    MIC_CILI_FIB_Z,
    MIC_HOMOGENEOUS,
    MIC_LAYER_Y,
    MIC_QUAD_FIB_XYZ,
    MIC_QUAD_FIB_XZ,
    MIC_QUAD_FIB_XZ_BROKEN_X,
    MIC_SPHERE,
)


def material2_mask(n: int, micro_type: int, params) -> np.ndarray:
    """(n,n,n) bool: True where the micro element belongs to material 2.
    Geometry tested at element centers of the unit-size RVE (params[0:3] =
    box dims, params[3] = width/radius fraction; reference defaults
    {1,1,1,0.5}, src/init.c:212)."""
    lx, ly, lz, w = (list(params) + [0.5] * 4)[:4]
    c = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(c * lx, c * ly, c * lz, indexing="ij")
    cx, cy, cz = lx / 2, ly / 2, lz / 2
    if micro_type == MIC_HOMOGENEOUS:
        return np.zeros((n, n, n), bool)
    if micro_type == MIC_SPHERE:
        r = w * min(lx, ly, lz) / 2
        return (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 < r * r
    if micro_type == MIC_LAYER_Y:
        return Y < w * ly
    if micro_type == MIC_CILI_FIB_Z:
        r = w * min(lx, ly) / 2
        return (X - cx) ** 2 + (Y - cy) ** 2 < r * r
    if micro_type == MIC_CILI_FIB_XZ:
        r = w * min(lx, ly) / 4
        fib_z = (X - cx) ** 2 + (Y - cy) ** 2 < r * r
        fib_x = (Z - cz) ** 2 + (Y - cy) ** 2 < r * r
        return fib_z | fib_x
    if micro_type in (MIC_QUAD_FIB_XYZ, MIC_QUAD_FIB_XZ,
                      MIC_QUAD_FIB_XZ_BROKEN_X):
        hw = w / 4
        fib_z = (np.abs(X - cx) < hw * lx) & (np.abs(Y - cy) < hw * ly)
        fib_x = (np.abs(Z - cz) < hw * lz) & (np.abs(Y - cy) < hw * ly)
        fib_y = (np.abs(X - cx) < hw * lx) & (np.abs(Z - cz) < hw * lz)
        if micro_type == MIC_QUAD_FIB_XYZ:
            return fib_z | fib_x | fib_y
        if micro_type == MIC_QUAD_FIB_XZ:
            return fib_z | fib_x
        # broken-x: x-fiber interrupted in the middle third
        broken = fib_x & ~(np.abs(X - cx) < lx / 6)
        return fib_z | broken
    raise ValueError(f"unknown micro_type {micro_type}")
