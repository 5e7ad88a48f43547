"""Trilinear hexahedral element tables.

Replaces the reference's per-call ``calc_B`` (src/assembly.c:195-254) and the
Gauss table ``xg`` (include/macroc.h:61-69) with precomputed constant tensors:
the element is identical for every cell of the structured grid, so the full
B-matrix for all 8 Gauss points is a single (8, 6, 8, 3) constant that XLA
folds into the assembly einsums.

Numerics:
  - 8 Gauss points at +-1/sqrt(3) in the reference's node ordering
    (VTK hexahedron ordering, type 12).
  - Voigt order (xx, yy, zz, xy, xz, yz) with engineering shear strains —
    derived from the B row layout at assembly.c:234-253.
  - ``ref_quirk=True`` replicates the reference's latent bug where calc_B
    shadows the global spacings with dx=dy=dz=1 (assembly.c:198): shape
    derivatives are w.r.t. a unit element while the quadrature weight uses
    the real element volume (SURVEY.md Appendix B.1).  ``False`` gives the
    physically correct B for spacing (hx, hy, hz).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

NGP = 8   # Gauss points per element (macroc.h:32)
NPE = 8   # nodes per element (macroc.h:33)
NVOI = 6  # Voigt components (macroc.h:34)
DIM = 3   # spatial dims (macroc.h:35)

CONSTXG = 0.577350269189626  # 1/sqrt(3) (macroc.h:52)

# Node sign pattern in natural coordinates; row n is the corner
# (xi, eta, zeta) of local node n.  Matches the xg table ordering
# (macroc.h:61-69) == VTK hexahedron node order.
NODE_SIGNS = np.array(
    [
        [-1, -1, -1],
        [+1, -1, -1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, +1, +1],
    ],
    dtype=np.int64,
)

# Grid-index offset of each local node relative to the element's low corner:
# node n sits at cell + NODE_OFFSETS[n].  Used by all gather/scatter kernels.
NODE_OFFSETS = ((NODE_SIGNS + 1) // 2).astype(np.int64)


def gauss_points() -> np.ndarray:
    """(8, 3) Gauss abscissae, identical layout to macroc.h:61-69."""
    return NODE_SIGNS.astype(np.float64) * CONSTXG


@lru_cache(maxsize=None)
def shape_derivatives(
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """dN_n/dx_d at every Gauss point: shape (NGP, NPE, DIM), float64.

    dN/dxi_d = (s_nd / 8) * prod_{e != d} (1 + s_ne * xi_e), mapped to
    physical coordinates by 2/h_d (the reference hard-codes h=1; pass the
    real spacing for the corrected mode).
    """
    xg = gauss_points()
    s = NODE_SIGNS.astype(np.float64)
    h = np.asarray(spacing, dtype=np.float64)
    dsh = np.empty((NGP, NPE, DIM), dtype=np.float64)
    for d in range(DIM):
        others = [e for e in range(DIM) if e != d]
        # (NGP, NPE) product over the two non-d directions
        prod = np.ones((NGP, NPE))
        for e in others:
            prod *= 1.0 + s[None, :, e] * xg[:, None, e]
        dsh[:, :, d] = s[None, :, d] / 8.0 * prod * (2.0 / h[d])
    return dsh


@lru_cache(maxsize=None)
def b_matrix(
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Strain-displacement tensor B: shape (NGP, NVOI, NPE, DIM), float64.

    strain[v] = sum_{n,d} B[gp, v, n, d] * u[n, d], Voigt order
    (xx, yy, zz, xy, xz, yz) with engineering shears — matches the row
    layout of calc_B (assembly.c:234-253).
    """
    return b_from_dsh(shape_derivatives(spacing))


def b_from_dsh(dsh: np.ndarray) -> np.ndarray:
    """B (NGP, NVOI, NPE, DIM) from shape derivatives dsh (NGP, NPE, DIM):
    each (node, dim) column has three nonzero Voigt rows, each holding one
    component of dsh (the pattern kernel K2 contracts with)."""
    B = np.zeros((NGP, NVOI, NPE, DIM), dtype=np.float64)
    B[:, 0, :, 0] = dsh[:, :, 0]
    B[:, 1, :, 1] = dsh[:, :, 1]
    B[:, 2, :, 2] = dsh[:, :, 2]
    B[:, 3, :, 0] = dsh[:, :, 1]
    B[:, 3, :, 1] = dsh[:, :, 0]
    B[:, 4, :, 0] = dsh[:, :, 2]
    B[:, 4, :, 2] = dsh[:, :, 0]
    B[:, 5, :, 1] = dsh[:, :, 2]
    B[:, 5, :, 2] = dsh[:, :, 1]
    return B


def b_for(grid_spacing: Tuple[float, float, float], ref_quirk: bool) -> np.ndarray:
    """B tensor for a grid: unit-element (reference-compatible) or corrected."""
    if ref_quirk:
        return b_matrix((1.0, 1.0, 1.0))
    return b_matrix(tuple(float(h) for h in grid_spacing))
