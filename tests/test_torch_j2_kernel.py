"""The J2 return map as one kernel (``macroc_tpu_torch/ops/j2_return.py``,
``csrc/j2_return.cu``).

On the CPU, ``J2Engine.homogenize`` takes the wrapper's plain version
(``j2_radial_return``) and is held to the JAX package's ``J2Engine`` on
seeded numpy inputs: strains spread around first yield, a tenth of them
set within 1e-6 relative of yield, from a state that already carries
plastic strain.  Tolerances, max abs difference over the reference's max
magnitude per output: 1e-12 at f64 (the same arithmetic, sums in another
order); 1e-5 at f32, with the plastic flags equal wherever |f_trial| >
1e-5 Sy and the tangent compared where the flags agree (at yield it jumps
from C to C_ep, and f32 roundoff may land a GP within 1e-6 of yield on
either side).  The same criteria hold the kernel to its plain version on
the card (tests marked ``gpu``, skipped without a CUDA device):

    python -m pytest --noconftest -o addopts="" tests/test_torch_j2_kernel.py -m gpu -q

The file imports JAX only inside the tests that compare with it, so the
``gpu`` tests run where JAX is not installed."""

import re

import numpy as np
import pytest
import torch

from macroc_tpu_torch.config import MaterialParams
from macroc_tpu_torch.constitutive import J2Engine, J2State
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.ops import _build
from macroc_tpu_torch.ops.j2_return import j2_return, j2_return_plain

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOLS = [(torch.float32, 1e-5), (torch.float64, 1e-12)]
NP = {torch.float32: np.float32, torch.float64: np.float64}
MAT = MaterialParams()
NAMES = ("stress", "ctan", "eps_p", "alpha", "f_trial")


def _inputs(batch, seed=7):
    """(eps, eps_p, alpha) as float64 numpy: per-GP strain magnitudes from 0
    to about twice first yield, eps_p and alpha nonzero; every tenth GP's
    elastic strain rescaled so that its trial norm lies within 1e-7..1e-6
    relative of the yield radius, on either side."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=batch + (6,)) * 1.5e-3 * rng.random(batch + (1,))
    eps_p = rng.normal(size=batch + (6,)) * 1e-4
    alpha = np.abs(rng.normal(size=batch)) * 1e-4
    C = elastic_matrix(MAT)
    e = eps - eps_p
    s = e @ C.T
    s[..., :3] -= s[..., :3].mean(axis=-1, keepdims=True)
    snorm = np.sqrt(np.sum(s[..., :3] ** 2, -1) + 2.0 * np.sum(s[..., 3:] ** 2, -1))
    radius = np.sqrt(2.0 / 3.0) * (MAT.Sy + MAT.Ka * alpha)
    near = (np.arange(snorm.size).reshape(batch) % 10) == 0
    delta = rng.choice([-1.0, 1.0], size=batch) * rng.uniform(1e-7, 1e-6, size=batch)
    scale = np.where(near, (1.0 + delta) * radius / snorm, 1.0)
    return eps_p + e * scale[..., None], eps_p, alpha


def _as(arrays, dtype, device):
    return [torch.as_tensor(a.astype(NP[dtype]), device=device) for a in arrays]


def _assert_close(got, want, tol, what):
    """got/want: (stress, ctan, eps_p, alpha, f_trial, plastic) as numpy."""
    same = got[5] == want[5]
    near = np.abs(want[4]) <= tol * MAT.Sy
    assert np.all(same | near), f"{what}: plastic differs away from yield"
    assert 0.3 < want[5].mean() < 0.7, want[5].mean()
    for name, g, w in zip(NAMES, got, want):
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        if name == "ctan":
            d = d * same[..., None, None]
        assert d.max() <= tol * np.abs(w).max(), (what, name, d.max() / np.abs(w).max())


def _numpy(hom):
    return [t.cpu().numpy() for t in (hom.stress, hom.ctan, hom.trial_state.eps_p,
                                      hom.trial_state.alpha, hom.f_trial, hom.non_linear)]


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_homogenize_matches_jax(dtype, tol):
    """The port's J2Engine.homogenize on the CPU against the JAX J2Engine."""
    import jax.numpy as jnp

    from macroc_tpu.constitutive.j2 import J2Engine as JJ2, J2State as JState

    arrays = _inputs((6, 5, 4, 8))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    eps, ep, al = (jnp.asarray(a, jdt) for a in arrays)
    hj = JJ2(MAT, jdt).homogenize(eps, JState(ep, al))
    eps, ep, al = _as(arrays, dtype, CPU)
    ht = J2Engine(MAT, dtype, CPU).homogenize(eps, J2State(ep, al))
    want = [np.asarray(t) for t in (hj.stress, hj.ctan, hj.trial_state.eps_p,
                                    hj.trial_state.alpha, hj.f_trial, hj.non_linear)]
    assert ht.stress.dtype == ht.ctan.dtype == dtype
    assert ht.non_linear.dtype == torch.bool
    _assert_close(_numpy(ht), want, tol, f"homogenize {dtype}")
    if dtype == torch.float64:
        assert np.array_equal(ht.non_linear.numpy(), want[5])
    assert np.array_equal(ht.cost.numpy(), np.asarray(hj.cost))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is its plain version, bit for bit, and
    launches nothing."""
    eps, ep, al = _as(_inputs((3, 4, 8)), torch.float64, CPU)
    C = elastic_matrix(MAT)
    before = j2_return.launches
    got = j2_return(eps, ep, al, MAT, C)
    want = j2_return_plain(eps, ep, al, MAT, C)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert j2_return.launches == before


def test_both_routes_take_the_matrix_they_are_given():
    """C is the one source of the elastic matrix: the kernel's launch
    constants are its 36 values, the plain version computes with it (a
    scaled C changes the answer), and a C of another shape raises."""
    from macroc_tpu_torch.ops.j2_return import _params

    C = 2.0 * elastic_matrix(MAT)
    assert np.array_equal(_params(MAT, C)[:36], C.ravel())
    eps, ep, al = _as(_inputs((3, 4, 8)), torch.float64, CPU)
    got = j2_return(eps, ep, al, MAT, C)[0]
    want = j2_return(eps, ep, al, MAT, elastic_matrix(MAT))[0]
    assert not torch.allclose(got, want)
    with pytest.raises(ValueError, match=r"\(6, 6\)"):
        _params(MAT, C[:5])


@pytest.mark.parametrize("name", sorted(n for n in _build._SIGNATURES if "j2_return" in n))
def test_entry_points_are_defined_in_the_source(name):
    """Every ``macroc_j2_return_*`` entry the loader binds is defined in
    csrc/j2_return.cu, which the build compiles; its argument count
    matches the binding."""
    assert "j2_return.cu" in _build.SOURCES
    src = (_build.CSRC_DIR / "j2_return.cu").read_text()
    assert re.search(rf"^J2_ENTRY\({name}, (float|double)\)$", src, re.M), name
    params = re.search(r"#define J2_ENTRY\(NAME, T\)(.*?)\{", src, re.S).group(1)
    assert params.count(",") + 1 == len(_build._SIGNATURES[name])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_kernel_matches_plain(cuda, dtype, tol):
    eps, ep, al = _as(_inputs((33, 17, 9, 8)), dtype, cuda)
    C = elastic_matrix(MAT)
    got = j2_return(eps, ep, al, MAT, C)
    want = j2_return_plain(eps, ep, al, MAT, C)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
    _assert_close([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want], tol,
                  f"kernel {dtype}")


@pytest.mark.gpu
def test_homogenize_counts_its_launches(cuda):
    eng = J2Engine(MAT, torch.float32, cuda)
    eps, ep, al = _as(_inputs((4, 4, 4, 8)), torch.float32, cuda)
    before = j2_return.launches
    eng.homogenize(eps, J2State(ep, al))
    eng.homogenize(eps, J2State(ep, al))
    assert j2_return.launches == before + 2


@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    eps, ep, al = _as(_inputs((4, 6, 8)), torch.float32, cuda)
    C = elastic_matrix(MAT)
    with pytest.raises(ValueError, match="contiguous"):
        j2_return(eps[:, 1:], ep[:, 1:], al[:, 1:], MAT, C)
    with pytest.raises(ValueError, match="dtype or device"):
        j2_return(eps, ep.double(), al, MAT, C)
    with pytest.raises(TypeError):
        j2_return(eps.half(), ep.half(), al.half(), MAT, C)
    with pytest.raises(ValueError, match="shape"):
        j2_return(eps, ep, al[..., :1], MAT, C)


@pytest.mark.gpu
def test_homogenize_allocates_only_its_outputs(cuda):
    """One homogenize's peak lies no more than its outputs' bytes plus 64
    MiB above what was allocated before it (the plain version's tangent
    alone adds three (...,6,6) tensors)."""
    eng = J2Engine(MAT, torch.float32, cuda)
    eps, ep, al = _as(_inputs((64, 64, 64, 8)), torch.float32, cuda)
    state = J2State(ep, al)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hom = eng.homogenize(eps, state)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (
        hom.stress, hom.ctan, hom.trial_state.eps_p, hom.trial_state.alpha, hom.f_trial,
        hom.non_linear, hom.cost))
    assert torch.cuda.max_memory_allocated() - base <= outputs + 64 * 2**20
