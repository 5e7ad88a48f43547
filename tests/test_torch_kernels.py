"""Kernels K1 and K1v1 (stencil SpMV) and K2 (assembly combine) of the
torch port.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels in interpret mode and its jnp
forms, at float64 on inputs made with numpy.  Tolerances: 1e-12 relative
for K1 and K1v1 (243-term sums in another order; K1v1's Pallas kernel
``stencil_matvec_pallas_v1`` has no interpret mode, and its oracle in the
JAX bench is ``stencil_matvec_soa``), 1e-10 relative for K2 (as the JAX
package's own mxu-vs-slab test, tests/test_kernels.py).  Random vectors,
never a constant one: a constant is a rigid-body null mode of an assembled
operator.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.fem.element import b_matrix
from macroc_tpu.fem.kernels import assemble_stencil_soa as jax_slab
from macroc_tpu.ops.assembly_pallas import assemble_stencil_soa_mxu
from macroc_tpu.ops.stencil_pallas import stencil_matvec_pallas
from macroc_tpu.ops.stencil_pallas import stencil_matvec_soa as jax_matvec_soa
from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
from macroc_tpu_torch.ops import assembly as asm
from macroc_tpu_torch.ops.stencil_spmv import (
    stencil_matvec,
    stencil_matvec_soa,
    stencil_matvec_v1,
)

torch.set_num_threads(1)

SHAPES = [(6, 6, 6), (5, 9, 4)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_matches_jax(shape):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(27, 3, 3) + shape)
    x = rng.normal(size=(3,) + shape)
    y = stencil_matvec(torch.as_tensor(A), torch.as_tensor(x)).numpy()
    assert _rel(y, jax_matvec_soa(jnp.asarray(A), jnp.asarray(x))) < 1e-12
    y_pl = stencil_matvec_pallas(jnp.asarray(A), jnp.asarray(x),
                                 tile=(4, 8, 128), interpret=True)
    assert _rel(y, y_pl) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_halo_form_matches_jax(shape):
    """halo=True with a zero ring equals the global product."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(27, 3, 3) + shape)
    x = rng.normal(size=(3,) + shape)
    xh = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1)))
    y = stencil_matvec(torch.as_tensor(A), torch.as_tensor(xh), halo=True).numpy()
    y_pl = stencil_matvec_pallas(jnp.asarray(A), jnp.asarray(xh),
                                 tile=(4, 8, 128), interpret=True, halo=True)
    assert _rel(y, y_pl) < 1e-12
    assert _rel(y, stencil_matvec_soa(torch.as_tensor(A), torch.as_tensor(x))) < 1e-12


def test_k1_plain_halo_ring_is_read():
    """Nonzero halo data must contribute (oracle: the global product on
    the extended grid, cropped to the core)."""
    rng = np.random.default_rng(2)
    n = (6, 6, 6)
    A = rng.normal(size=(27, 3, 3) + n)
    xh = rng.normal(size=(3,) + tuple(m + 2 for m in n))
    y = stencil_matvec(torch.as_tensor(A), torch.as_tensor(xh), halo=True).numpy()
    Ae = np.pad(A, ((0, 0),) * 3 + ((1, 1),) * 3)
    y_ref = np.asarray(jax_matvec_soa(jnp.asarray(Ae), jnp.asarray(xh)))[:, 1:-1, 1:-1, 1:-1]
    assert _rel(y, y_ref) < 1e-12
    y_pl = stencil_matvec_pallas(jnp.asarray(A), jnp.asarray(xh),
                                 tile=(4, 8, 128), interpret=True, halo=True)
    assert _rel(y, y_pl) < 1e-12


def test_k1_cpu_tensor_runs_plain_version():
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(27, 3, 3, 4, 3, 5)))
    x = torch.as_tensor(rng.normal(size=(3, 4, 3, 5)))
    before = stencil_matvec.launches
    assert torch.equal(stencil_matvec(A, x), stencil_matvec_soa(A, x))
    assert stencil_matvec.launches == before


@pytest.mark.parametrize("tile", [(4, 4, 32), (3, 5, 2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1v1_plain_matches_jax(shape, tile):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(27, 3, 3) + shape)
    x = rng.normal(size=(3,) + shape)
    before = stencil_matvec_v1.launches
    y = stencil_matvec_v1(torch.as_tensor(A), torch.as_tensor(x), tile=tile).numpy()
    assert stencil_matvec_v1.launches == before  # CPU tensors: plain version
    assert _rel(y, jax_matvec_soa(jnp.asarray(A), jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("tile", [(8, 8, 32), (1, 1, 1025), (0, 4, 32), (4, 32)])
def test_k1v1_rejects_bad_tile(tile):
    """A tile above 1024 threads (one per node), or not three positive
    extents, raises on any device."""
    A = torch.zeros((27, 3, 3, 4, 4, 4))
    with pytest.raises(ValueError):
        stencil_matvec_v1(A, torch.zeros((3, 4, 4, 4)), tile=tile)


def _k2_case(shape, seed):
    rng = np.random.default_rng(seed)
    B = b_matrix((1.0, 1.1, 0.9))
    ct = rng.normal(size=tuple(n - 1 for n in shape) + (8, 6, 6))
    before = asm.assemble_stencil_soa_kernel.launches
    A = asm.assemble_stencil_soa_kernel(
        torch.as_tensor(ct), torch.as_tensor(B), 0.125, shape
    ).numpy()
    assert asm.assemble_stencil_soa_kernel.launches == before
    return B, ct, A


def test_k2_plain_matches_jax_pallas():
    """Against the Pallas combine in interpret mode.  One shape: the
    interpreter compiles the unrolled 576-channel kernel body for ~30 s; the
    odd extents exercise its z-rotate and padding."""
    shape = (6, 5, 4)
    B, ct, A = _k2_case(shape, 10)
    a_mxu = assemble_stencil_soa_mxu(jnp.asarray(ct), jnp.asarray(B), 0.125,
                                     shape, interpret=True)
    assert _rel(A, a_mxu) < 1e-10


@pytest.mark.parametrize("shape", [(6, 5, 4), (5, 2, 2), (9, 9, 9)])
def test_k2_plain_matches_slab(shape):
    B, ct, A = _k2_case(shape, 11)
    assert _rel(A, jax_slab(jnp.asarray(ct), jnp.asarray(B), 0.125, shape)) < 1e-10
    # the port's own slab form, the kernel path's oracle on the card
    slab = assemble_stencil_soa(torch.as_tensor(ct), torch.as_tensor(B), 0.125, shape)
    assert _rel(A, slab.numpy()) < 1e-10


def test_k2_combine_table_covers_every_channel_once():
    """The kernel's constant map: each of the 576 Ke channels feeds exactly
    one stencil entry; the diagonal offset gathers from all 8 elements."""
    t = asm.combine_table()
    assert t.shape == (243, 8)
    used = t[t >= 0]
    assert sorted(used.tolist()) == list(range(576))
    for a in range(8):
        col = t[:, a]
        assert np.all((col < 0) | (col // 72 == a))
    diag = [13 * 9 + d * 3 + e for d in range(3) for e in range(3)]
    assert np.all(t[diag] >= 0)
