"""Gather-free multi-process VTU output support (torch form of
``macroc_tpu/io/parallel_vtu.py``, one rank per process).

The reference's VTU path is each MPI rank writing its OWN piece from local
ghosted data (src/output.c:78-79) — no global array ever exists.  Here
width-h halo exchanges (`parallel.halo.ghosted_blocks`) give every rank an
owned-plus-halo patch of each output field (the PETSc *local ghosted
vector* layout); each DMDA piece is then assigned to a rank whose patch
covers the piece's ghost box and written from host-local data.  Peak host
memory per process = its block + halo, at any scale.

Why a halo wider than 1: the rank blocks split the PADDED grid evenly
(ceil(n/p) per rank), while the output pieces follow the reference's DMDA
ownership rule on the REAL grid (base + remainder-first; grid.py).  The two
decompositions drift by up to |si_dmda - d*s_even| nodes, so the halo is
sized ``misalignment + 1`` per axis — every piece's ghost box is then
covered by the rank of the same coordinates (proof in ``halo_widths``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from macroc_tpu_torch.grid import StructuredGrid3D


def halo_widths(
    grid: StructuredGrid3D, node_shape: Tuple[int, int, int]
) -> Tuple[int, int, int]:
    """Per-axis ghost width for `ghosted_blocks` such that DMDA piece d's
    ghost box [si-1, si+n+1) is always inside even-shard d's extended region
    [d*s - h, (d+1)*s + h): with h = max_d|si_dmda(d) - d*s| + 1,
    si-1 >= d*s - h and si + n + 1 = si(d+1) + 1 <= (d+1)*s + h."""
    hs = []
    counts = grid.node_counts()
    for axis in range(3):
        p = grid.procs[axis]
        s_even = node_shape[axis] // p
        starts = np.cumsum([0] + counts[axis][:-1])
        mis = max(abs(int(st) - d * s_even) for d, st in enumerate(starts))
        h = mis + 1
        if h > s_even:
            raise ValueError(
                f"axis {axis}: required halo {h} exceeds shard extent "
                f"{s_even} — decomposition too fine for per-process IO"
            )
        hs.append(h)
    return tuple(hs)


def _process_boxes(mesh) -> Dict[int, Tuple[range, range, range]]:
    """Per-process box of rank-grid coordinates (ci,cj,ck): one rank per
    process, so each box is the rank's own coordinates (``mesh`` a
    ``parallel.mesh.RankMesh``)."""
    grid = mesh.grid
    return {r: tuple(range(c, c + 1) for c in grid.rank_coords(r))
            for r in range(grid.nproc)}


def assign_pieces(
    grid: StructuredGrid3D,
    node_shape: Tuple[int, int, int],
    halo: Tuple[int, int, int],
    mesh,
) -> Dict[int, int]:
    """piece rank -> process index, deterministically on every process.
    A piece goes to the LOWEST process whose ghosted patch covers its ghost
    box."""
    boxes = _process_boxes(mesh)
    s = [node_shape[a] // grid.procs[a] for a in range(3)]
    out = {}
    for r in range(grid.nproc):
        b = grid.local_box(r)
        gbox = (
            (b.si_ghost, b.si_ghost + b.nx_ghost),
            (b.sj_ghost, b.sj_ghost + b.ny_ghost),
            (b.sk_ghost, b.sk_ghost + b.nz_ghost),
        )
        owner = None
        for p in sorted(boxes):
            rngs = boxes[p]
            ok = all(
                rngs[a].start * s[a] - halo[a] <= gbox[a][0]
                and gbox[a][1] <= (rngs[a].stop) * s[a] + halo[a]
                for a in range(3)
            )
            if ok:
                owner = p
                break
        if owner is None:
            raise RuntimeError(
                f"VTU piece {r} ghost box {gbox} not covered by any "
                "process patch — halo_widths invariant violated"
            )
        out[r] = owner
    return out


def extract_patch(
    ghosted: Sequence,
    mesh,
    halo: Tuple[int, int, int],
) -> Tuple[Tuple[int, int, int], List[np.ndarray]]:
    """This process's host patch of each field from its ``ghosted_blocks``
    outputs (``parallel/halo.py``: the rank's block grown by ``halo`` per
    face).

    Returns (origin, patches): patch[i] covers global (padded-grid) region
    [origin, origin + patch.shape[:3]) of field i; origin may be negative
    (halo sticking out of the grid — zero-filled, never read)."""
    origin = tuple(s - h for s, h in zip(mesh.start, halo))
    return origin, [g.detach().cpu().numpy() for g in ghosted]
