"""The CUDA kernels of the torch port against their plain PyTorch versions,
on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  The file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py -q

Tolerances (max abs difference over max abs value): 1e-5 in float32 and
1e-12 in float64 — the kernels sum in another order than the plain
versions; the K2 combine adds in the plain version's order, so it is held
bitwise."""

import numpy as np
import pytest
import torch

from macroc_tpu_torch import MacroConfig
from macroc_tpu_torch.fem.element import b_matrix
from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
from macroc_tpu_torch.ops import assembly as asm
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, stencil_matvec_soa
from macroc_tpu_torch.problem import MacroProblem

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

TOLS = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64)])
def test_k1_kernel_matches_plain(cuda, shape, dtype, tol):
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(27, 3, 3) + shape), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
    xh = torch.as_tensor(
        rng.normal(size=(3,) + tuple(n + 2 for n in shape)), dtype=dtype, device=cuda
    )
    before = stencil_matvec.launches
    assert _rel(stencil_matvec(A, x), stencil_matvec_soa(A, x)) < tol
    assert _rel(stencil_matvec(A, xh, halo=True), stencil_matvec_soa(A, xh, halo=True)) < tol
    assert stencil_matvec.launches == before + 2


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("ne", [(20, 9, 27), (32, 32, 32)])
def test_k2_kernel_matches_plain(cuda, ne, dtype, tol):
    rng = np.random.default_rng(5)
    shape = tuple(n + 1 for n in ne)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=cuda)
    ct = torch.as_tensor(rng.normal(size=ne + (8, 6, 6)), dtype=dtype, device=cuda)
    Ke = asm.element_stiffness_cm(ct, B, 0.1)
    assert torch.equal(asm.combine_cuda(Ke, shape), asm.combine_plain(Ke, shape))
    before = asm.assemble_stencil_soa_kernel.launches
    A = asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape)
    assert asm.assemble_stencil_soa_kernel.launches == before + 1
    assert _rel(A, assemble_stencil_soa(ct, B, 0.1, shape)) < tol


def test_wrappers_reject_bad_input(cuda):
    A = torch.zeros((27, 3, 3, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        stencil_matvec(A, torch.zeros((3, 4, 4, 5), device=cuda))
    with pytest.raises(TypeError):
        stencil_matvec(A.half(), torch.zeros((3, 4, 4, 4), device=cuda).half())
    with pytest.raises(ValueError):
        asm.combine_cuda(torch.zeros((576, 3, 3, 3), device=cuda), (4, 4, 5))


def test_newton_step_on_gpu_matches_cpu(cuda):
    """One J2 + MG Newton step on a 17^3 cube: the kernels' path on the
    card against the plain path on the CPU, at float64.  The CG iterates
    carry roundoff of another summation order: u to 1e-8."""
    cfg = MacroConfig(nx=17, ny=17, nz=17, lx=2.0, ly=2.0, lz=2.0, bc_type=0,
                      dtype="float64", pc_type="mg", dt=0.05)
    out = {}
    for dev in ("cpu", cuda):
        p = MacroProblem(cfg, dev)
        u, state = p.init_fields()
        u, state, d = p.time_step(u, state, cfg.displacement(1))
        out[str(dev)] = (u.cpu(), d)
    (u_c, d_c), (u_g, d_g) = out["cpu"], out[str(cuda)]
    assert d_g.converged and d_g.n_solves == d_c.n_solves
    assert np.isclose(d_g.res_norms[0], d_c.res_norms[0], rtol=1e-12)
    assert _rel(u_g, u_c) < 1e-8
