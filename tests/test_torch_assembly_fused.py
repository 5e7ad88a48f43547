"""Kernel K2 (``csrc/assembly_fused.cu``) replayed on the CPU.

The CUDA kernel runs only on a card.  Its arithmetic and its tiling are
replayed here in numpy, step for step: the sparse-B contraction (a thread's
Ke column from B's three nonzero Voigt rows per column), the node column
(TY x TZ) marching along x through its chunk of node layers, the element
layer's halo elements in rounds of at most S elements of one colour
(parity class: elements of one colour share no node), the scatter into a
two-layer accumulator ring, and the write-out of each node layer when the
element layer above it is done.  The replica is held at
float64 to the wrapper's plain version on CPU tensors and to the JAX
package's ``assemble_stencil_soa_mxu`` (interpret mode) within 1e-12
relative: the same sums in another order.  Every node must be written
exactly once, with no entry left unwritten (the kernel's output is
``torch.empty``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.fem.element import b_matrix as jax_b_matrix
from macroc_tpu.fem.kernels import assemble_stencil_soa as jax_slab
from macroc_tpu.ops.assembly_pallas import assemble_stencil_soa_mxu
from macroc_tpu_torch import MacroConfig
from macroc_tpu_torch import problem as tproblem
from macroc_tpu_torch.fem.element import NODE_OFFSETS, b_matrix
from macroc_tpu_torch.ops import assembly as asm

torch.set_num_threads(1)
TOL = 1e-12


# the kernel's tables (voigt_row, dsh_comp, off_x/y/z in the .cu source)
def voigt_row(d, t):
    return [[0, 3, 4], [1, 3, 5], [2, 4, 5]][d][t]


def dsh_comp(d, t):
    return [[0, 1, 2], [1, 0, 2], [2, 0, 1]][d][t]


OFF = np.array([[a in (1, 2, 5, 6), a in (2, 3, 6, 7), a >= 4] for a in range(8)], int)
R = np.array([[voigt_row(d, t) for t in range(3)] for d in range(3)])
D = np.array([[dsh_comp(d, t) for t in range(3)] for d in range(3)])


def k_table():
    """(8, 72): stencil entry K of element node a's Ke channel (d, b, e), as
    the kernel's scatter computes it."""
    K = np.empty((8, 3, 8, 3), int)
    for a in range(8):
        for b in range(8):
            o = (OFF[b, 0] - OFF[a, 0] + 1) * 9 + (OFF[b, 1] - OFF[a, 1] + 1) * 3 \
                + (OFF[b, 2] - OFF[a, 2] + 1)
            for d in range(3):
                for e in range(3):
                    K[a, d, b, e] = o * 9 + d * 3 + e
    return K.reshape(8, 72)


K_TABLE = k_table()


def ke_sparse(C, dsh, wg):
    """Ke (n, a, d, b, e) of elements C (n, 8, 6, 6) by the kernel's
    contraction: a thread's column (b, e) first forms
    CB[v] = sum_t C[v, R[e][t]] * dsh[g, b, D[e][t]] * wg, then each row
    (a, d) adds sum_t dsh[g, a, D[d][t]] * CB[R[d][t]]."""
    md = dsh[:, :, D] * wg                       # (g, b, e, t)
    CB = np.einsum("ngvet,gbet->ngvbe", C[:, :, :, R], md)
    return np.einsum("gadt,ngdtbe->nadbe", dsh[:, :, D], CB[:, :, R])


def colours(eyA, eyB, ezA, ezB):
    """The column's halo elements in the kernel's colour order: parity
    classes (y, z) = (0,0), (0,1), (1,0), (1,1), each row-major."""
    out = []
    for c in range(4):
        y0 = eyA + ((eyA & 1) != (c >> 1))
        z0 = ezA + ((ezA & 1) != (c & 1))
        out.append([(ey, ez) for ey in range(y0, eyB + 1, 2) for ez in range(z0, ezB + 1, 2)])
    return out


def replica(ctan, dsh, wg, grid_shape, ty, tz, S, xchunk):
    """The kernel's blocks, rounds and write-outs in numpy."""
    nx, ny, nz = grid_shape
    nex, ney, nez = nx - 1, ny - 1, nz - 1
    A = np.full((243, nx, ny, nz), np.nan)
    writes = np.zeros(grid_shape, int)
    for bz in range(-(-nz // tz)):
        for by in range(-(-ny // ty)):
            for bx in range(-(-nx // xchunk)):
                k0, j0, i0 = bz * tz, by * ty, bx * xchunk
                i1 = min(i0 + xchunk, nx)
                eyA, eyB = max(j0 - 1, 0), min(j0 + ty - 1, ney - 1)
                ezA, ezB = max(k0 - 1, 0), min(k0 + tz - 1, nez - 1)
                # a round: at most S elements of one colour
                rounds = [els[f:f + S] for els in colours(eyA, eyB, ezA, ezB)
                          for f in range(0, len(els), S)]
                exA, exB = max(i0 - 1, 0), min(i1 - 1, nex - 1)
                assert rounds and exB >= exA
                acc = np.zeros((2, 243, ty, tz))

                def write_layer(n):
                    for jl in range(ty):
                        for kl in range(tz):
                            j, k = j0 + jl, k0 + kl
                            if j < ny and k < nz:
                                A[:, n, j, k] = acc[n & 1, :, jl, kl]
                                writes[n, j, k] += 1
                    acc[n & 1] = 0.0

                for ex in range(exA, exB + 1):
                    for els in rounds:
                        ke = ke_sparse(np.stack([ctan[ex, ey, ez] for ey, ez in els]), dsh, wg)
                        touched = set()
                        for (ey, ez), k in zip(els, ke):
                            for a in range(8):
                                nl = ex + OFF[a, 0]
                                jl, kl = ey + OFF[a, 1] - j0, ez + OFF[a, 2] - k0
                                if not (i0 <= nl < i1 and 0 <= jl < ty and 0 <= kl < tz):
                                    continue
                                # one writer per accumulator entry in a round
                                assert (nl, jl, kl) not in touched
                                touched.add((nl, jl, kl))
                                acc[nl & 1, K_TABLE[a], jl, kl] += k[a].reshape(72)
                    if ex >= i0:
                        write_layer(ex)
                    if ex == nex - 1 and i1 == nx:
                        write_layer(nx - 1)
    assert np.all(writes == 1), "a node was written other than once"
    assert not np.isnan(A).any()
    return A


def _case(shape, seed, spacing=(1.0, 1.1, 0.9)):
    rng = np.random.default_rng(seed)
    B = b_matrix(spacing)
    ct = rng.normal(size=tuple(n - 1 for n in shape) + (8, 6, 6))
    dsh = asm.b_dsh(torch.as_tensor(B))
    return B, ct, dsh


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_tables_agree_with_the_combine_map():
    """The scatter's K and the kernel's B pattern are the package's:
    combine_table's channel a*72 + (d*8+b)*3 + e feeds K_TABLE's entry."""
    t = asm.combine_table()
    assert np.array_equal(OFF, NODE_OFFSETS)
    for a in range(8):
        for d in range(3):
            for b in range(8):
                for e in range(3):
                    assert t[K_TABLE[a].reshape(3, 8, 3)[d, b, e], a] == a * 72 + (d * 8 + b) * 3 + e
    dsh = np.random.default_rng(0).normal(size=(8, 8, 3))
    B = np.zeros((8, 6, 8, 3))
    for d in range(3):
        for t_ in range(3):
            B[:, R[d, t_], :, d] = dsh[:, :, D[d, t_]]
    assert np.array_equal(asm.b_from_dsh(dsh), B)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.5, 1.5, 2.0)])
def test_sparse_contraction_matches_dense(spacing):
    rng = np.random.default_rng(1)
    B = b_matrix(spacing)
    C = rng.normal(size=(5, 8, 6, 6))
    dense = np.einsum("gvad,ngvw,gwbe->nadbe", B, C, B) * 0.3
    assert _rel(ke_sparse(C, asm.b_dsh(torch.as_tensor(B)), 0.3), dense) < 1e-14


# (ty, tz, S): the kernel's f32 and f64 tiles, and small odd ones that
# leave ragged columns and colours split over several rounds
TILES = [(7, 8, 20), (4, 8, 8), (3, 2, 5), (5, 3, 2)]
# no tile divides (6,5,4) or (11,9,13); (5,3,9) and (10,3,10) are ny=3
# pancakes; (3,3,3) is 2x2x2 elements
SHAPES = [(6, 5, 4), (5, 3, 9), (3, 3, 3), (10, 3, 10), (11, 9, 13)]


# node layers per block: one per block, ragged chunks, the whole x extent
@pytest.mark.parametrize("xchunk", [1, 3, 100])
@pytest.mark.parametrize("tile", TILES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_replica_matches_the_plain_version(shape, tile, xchunk):
    B, ct, dsh = _case(shape, sum(shape))
    ty, tz, S = tile
    A = replica(ct, dsh, 0.125, shape, ty, tz, S, min(xchunk, shape[0]))
    before = asm.assemble_stencil_soa_kernel.launches
    A_plain = asm.assemble_stencil_soa_kernel(torch.as_tensor(ct), torch.as_tensor(B),
                                              0.125, shape)
    assert asm.assemble_stencil_soa_kernel.launches == before  # CPU: plain version
    assert _rel(A, A_plain.reshape(243, *shape).numpy()) < TOL
    assert _rel(A, jax_slab(jnp.asarray(ct), jnp.asarray(B), 0.125, shape).reshape(243, *shape)) < TOL


@pytest.mark.parametrize("shape", [(3, 3, 3), (5, 3, 6)], ids=str)
def test_replica_matches_jax_pallas(shape):
    """Against the TPU kernel's function in interpret mode (one compile of
    its 576-channel body per shape)."""
    B, ct, dsh = _case(shape, 3 + sum(shape))
    A = replica(ct, dsh, 0.125, shape, 4, 8, 8, 2)
    a_mxu = assemble_stencil_soa_mxu(jnp.asarray(ct), jnp.asarray(B), 0.125, shape,
                                     interpret=True)
    assert _rel(A, np.asarray(a_mxu).reshape(243, *shape)) < TOL
    assert np.array_equal(np.asarray(jax_b_matrix((1.0, 1.1, 0.9))), B)


def test_b_pattern_check_raises():
    rng = np.random.default_rng(2)
    ct = torch.as_tensor(rng.normal(size=(2, 2, 2, 8, 6, 6)))
    dense = torch.as_tensor(rng.normal(size=(8, 6, 8, 3)))
    with pytest.raises(ValueError, match="pattern"):
        asm.assemble_stencil_soa_kernel(ct, dense, 0.125, (3, 3, 3))
    # the right zeros, but the shear row holds another value than the
    # normal rows' dsh component
    B = b_matrix((1.0, 1.0, 1.0)).copy()
    B[3, 3, 5, 0] *= 1.5
    with pytest.raises(ValueError, match="pattern"):
        asm.b_dsh(torch.as_tensor(B))
    with pytest.raises(ValueError, match="8, 6, 8, 3"):
        asm.b_dsh(torch.zeros(8, 6, 8))


def test_main_path_ctan_passes_the_layout_check(monkeypatch):
    """The tangents the Newton step hands the assembler (a slice of a
    node-shaped field, not contiguous) and the coarsened MG level tangents
    pass K2's layout check; a transposed field does not."""
    seen = []
    slab = tproblem._ASSEMBLERS["slab"]

    def spy(ctan, B, wg, shape, dsh=None):
        seen.append(ctan)
        return slab(ctan, B, wg, shape, dsh=dsh)

    monkeypatch.setitem(tproblem._ASSEMBLERS, "slab", spy)
    cfg = MacroConfig(nx=9, ny=5, nz=7, lx=2.0, ly=2.0, lz=2.0, bc_type=0, pc_type="mg",
                      dtype="float64", constitutive="j2", dt=0.05)
    p = tproblem.MacroProblem(cfg, "cpu")
    p.time_step(*p.init_fields(), cfg.displacement(1))
    assert len(seen) >= 3 and not seen[0].is_contiguous()
    for ctan in seen:
        asm.check_fused_layout(ctan)
    with pytest.raises(ValueError, match="stride"):
        asm.check_fused_layout(seen[0].transpose(4, 5))
    with pytest.raises(ValueError, match="stride"):
        asm.check_fused_layout(seen[0].transpose(1, 2))


def test_b_is_read_once_not_per_assembly(monkeypatch):
    """K2's wrapper reads B to the host (``b_dsh``) only when no dsh is
    passed; MacroProblem takes it once, and build_hierarchy hands each MG
    level the shape derivatives its B is made of, which equal b_dsh of
    that B."""
    from macroc_tpu_torch.fem.element import shape_derivatives
    from macroc_tpu_torch.solve.mg import build_hierarchy

    reads = []
    real = asm.b_dsh
    monkeypatch.setattr(asm, "b_dsh", lambda B: reads.append(1) or real(B))
    rng = np.random.default_rng(5)
    ct = torch.as_tensor(rng.normal(size=(4, 2, 5, 8, 6, 6)))
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)))
    A = asm.assemble_stencil_soa_kernel(ct, B, 0.125, (5, 3, 6))
    assert len(reads) == 1
    dsh = real(B)
    assert torch.equal(asm.assemble_stencil_soa_kernel(ct, B, 0.125, (5, 3, 6), dsh=dsh), A)
    assert len(reads) == 1
    for spacing in [(1.0, 1.0, 1.0), (2.0, 1.0, 2.0), (0.5, 0.25, 1.0)]:
        assert np.array_equal(shape_derivatives(spacing),
                              real(torch.as_tensor(b_matrix(spacing))))
    ctan = torch.as_tensor(rng.normal(size=(8, 2, 8, 8, 6, 6)))
    mask = torch.zeros((3, 9, 3, 9), dtype=torch.bool)
    levels = build_hierarchy(ctan, mask, (1.0, 1.0, 1.0), True,
                             assemble_fn=asm.assemble_stencil_soa_kernel)
    assert len(levels) >= 3 and len(reads) == 1
    plain = build_hierarchy(ctan, mask, (1.0, 1.0, 1.0), True)
    for a, b in zip(levels, plain):
        assert _rel(a.A_soa.numpy(), b.A_soa.numpy()) < TOL
