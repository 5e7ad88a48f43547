"""The J2 radial-return map with its consistent tangent as one kernel
(``csrc/j2_return.cu``), with its plain version ``j2_radial_return``.
Port-only: the JAX package's ``J2Engine.homogenize``
(``macroc_tpu/constitutive/j2.py:149-210``) is jnp code that XLA fuses; the
plain version's tangent alone builds three (...,6,6) tensors (2.25 GiB each
at 128^3 nodes x 8 GPs in float32).  ``j2_radial_return`` is also the
micro-FE engine's map, on per-element material fields.

``j2_return`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing falls back from one to the other.  Both
take the elastic matrix from the one host array C they are given.  The
kernel allocates nothing beyond its outputs, which have the plain
version's shapes, dtypes and contiguous layouts; it takes contiguous
inputs only and raises on any other, since copying them would raise the
peak it exists to cut.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from macroc_tpu_torch.config import MaterialParams

_SQ23 = float(np.sqrt(2.0 / 3.0))


def _minor(v, k: int):
    """A material parameter broadcast against k trailing minor dims: a
    Python float as it is, a field tensor with k singleton dims added."""
    return v[(...,) + (None,) * k] if torch.is_tensor(v) else v


def j2_radial_return(eps, eps_p, alpha, lam, mu, Sy, Ka, C=None,
                     tangent: bool = True):
    """Functional radial-return map: the plain version of ``j2_return``'s
    kernel (J2Engine, scalar material), and the micro-FE engine's map
    (per-micro-element material fields).

    lam, mu, Sy, Ka are Python floats or tensors that broadcast against the
    batch eps[..., 0].  The trial stress is lam tr(e) I + 2 mu e (shear rows
    mu * gamma), or C @ e when the engine passes its 6x6 elastic matrix C,
    which is then also the elastic tangent.  ``tangent=False`` skips the
    consistent tangent (ctan is None), for callers that only screen.

    Returns (stress, ctan, eps_p_new, alpha_new, f_trial, plastic); the new
    internal variables equal the old ones where the GP stays elastic."""
    kappa = lam + 2.0 * mu / 3.0
    e = eps - eps_p
    if C is None:
        tr = e[..., 0] + e[..., 1] + e[..., 2]
        mu1 = _minor(mu, 1)
        sig_tr = torch.cat(
            [(lam * tr)[..., None] + 2.0 * mu1 * e[..., :3], mu1 * e[..., 3:]],
            dim=-1,
        )
    else:
        sig_tr = e @ C.T
    del e

    p = (sig_tr[..., 0] + sig_tr[..., 1] + sig_tr[..., 2]) / 3.0
    s = sig_tr.clone()
    s[..., :3] -= p[..., None]
    snorm = torch.sqrt(
        torch.sum(s[..., :3] ** 2, dim=-1)
        + 2.0 * torch.sum(s[..., 3:] ** 2, dim=-1)
    )
    f_trial = snorm - _SQ23 * (Sy + Ka * alpha)
    plastic = f_trial > 0.0

    dgamma = torch.where(
        plastic, f_trial / (2.0 * mu + (2.0 / 3.0) * Ka), 0.0
    )
    safe = torch.clamp_min(snorm, 1e-30)
    n = s / safe[..., None]
    del s

    stress = sig_tr - (2.0 * mu * dgamma)[..., None] * n
    del sig_tr

    # engineering plastic-strain increment: shear entries doubled
    dn = n.clone()
    dn[..., 3:] *= 2.0
    eps_p_new = torch.where(plastic[..., None], eps_p + dgamma[..., None] * dn, eps_p)
    del dn
    alpha_new = torch.where(plastic, alpha + _SQ23 * dgamma, alpha)

    ctan = None
    if tangent:
        # consistent tangent, summed in the reference's order:
        # (kappa 1x1 + 2mu theta I_dev) - (2mu thetabar) n x n
        dt, dev = dgamma.dtype, dgamma.device
        ones33 = torch.as_tensor(_ONES33, dtype=dt, device=dev)
        i_dev = torch.as_tensor(_I_DEV, dtype=dt, device=dev)
        theta = 1.0 - 2.0 * mu * dgamma / safe
        thetabar = 1.0 / (1.0 + Ka / (3.0 * mu)) - (1.0 - theta)
        C_ep = ((2.0 * mu) * theta)[..., None, None] * i_dev
        C_ep += _minor(kappa, 2) * ones33
        nn = n[..., :, None] * n[..., None, :]
        C_ep -= nn.mul_(((2.0 * mu) * thetabar)[..., None, None])
        del nn
        if C is None:
            C = _minor(kappa, 2) * ones33 + _minor(2.0 * mu, 2) * i_dev
        ctan = torch.where(plastic[..., None, None], C_ep, C)
    return stress, ctan, eps_p_new, alpha_new, f_trial, plastic


_ONES33 = np.zeros((6, 6))
_ONES33[:3, :3] = 1.0
_I_DEV = np.diag([1, 1, 1, 0.5, 0.5, 0.5]) - _ONES33 / 3.0


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def j2_return_plain(eps, eps_p, alpha, mat: MaterialParams, C: np.ndarray):
    """``j2_radial_return`` with the engine's scalar material and its
    elastic matrix C (a (6, 6) host array)."""
    C = torch.as_tensor(C, dtype=eps.dtype, device=eps.device)
    return j2_radial_return(eps, eps_p, alpha, mat.lam, mat.mu, mat.Sy, mat.Ka, C=C)


def _params(mat: MaterialParams, C: np.ndarray) -> np.ndarray:
    """The kernel's constants in double, each computed as the plain version
    computes its Python float: C row-major, 2 mu, the dgamma denominator,
    Sy, Ka, kappa, thetabar's constant term, sqrt(2/3)."""
    C = np.asarray(C, dtype=np.float64)
    if C.shape != (6, 6):
        raise ValueError(f"j2_return needs a (6, 6) elastic matrix, got {C.shape}")
    lam, mu, Sy, Ka = mat.lam, mat.mu, mat.Sy, mat.Ka
    return np.concatenate([
        C.ravel(),
        [2.0 * mu, 2.0 * mu + (2.0 / 3.0) * Ka, Sy, Ka, lam + 2.0 * mu / 3.0,
         1.0 / (1.0 + Ka / (3.0 * mu)), float(np.sqrt(2.0 / 3.0))],
    ]).astype(np.float64)


def _check(eps, eps_p, alpha):
    """The kernel takes contiguous f32 or f64 eps (..., 6), eps_p of the
    same shape and alpha (...,), of one dtype on one device, each on a
    16-byte boundary (it loads and stores 8 and 16 bytes at a time)."""
    if eps.shape[-1:] != (6,) or eps_p.shape != eps.shape or alpha.shape != eps.shape[:-1]:
        raise ValueError(f"j2_return needs eps (..., 6), eps_p of its shape and alpha "
                         f"(...,), got {tuple(eps.shape)}, {tuple(eps_p.shape)}, "
                         f"{tuple(alpha.shape)}")
    if eps.dtype not in _SUFFIX:
        raise TypeError(f"j2_return takes float32 or float64, got {eps.dtype}")
    for t in (eps_p, alpha):
        if t.dtype != eps.dtype or t.device != eps.device:
            raise ValueError("j2_return: eps, eps_p and alpha differ in dtype or device")
    for t in (eps, eps_p, alpha):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("j2_return needs contiguous inputs on 16-byte boundaries "
                             "(a copy would raise the peak the kernel cuts)")


def j2_return(eps, eps_p, alpha, mat: MaterialParams, C: np.ndarray):
    """(stress, ctan, eps_p_new, alpha_new, f_trial, plastic) of the J2
    return map at every GP with the elastic matrix C (a (6, 6) host array):
    ``j2_return_kernel`` on CUDA tensors, which takes C's 36 values as
    launch constants, the plain version on CPU tensors.  Counts launches in
    ``j2_return.launches``."""
    if not eps.is_cuda:
        return j2_return_plain(eps, eps_p, alpha, mat, C)
    from macroc_tpu_torch.ops import _build

    _check(eps, eps_p, alpha)
    batch = tuple(eps.shape[:-1])
    like = dict(dtype=eps.dtype, device=eps.device)
    stress = torch.empty(batch + (6,), **like)
    ctan = torch.empty(batch + (6, 6), **like)
    eps_p_new = torch.empty(batch + (6,), **like)
    alpha_new = torch.empty(batch, **like)
    f_trial = torch.empty(batch, **like)
    plastic = torch.empty(batch, dtype=torch.bool, device=eps.device)
    params = _params(mat, C)
    lib = _build.load()
    with torch.cuda.device(eps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"macroc_j2_return_{_SUFFIX[eps.dtype]}")(
            eps.data_ptr(), eps_p.data_ptr(), alpha.data_ptr(), stress.data_ptr(),
            ctan.data_ptr(), eps_p_new.data_ptr(), alpha_new.data_ptr(), f_trial.data_ptr(),
            plastic.data_ptr(), math.prod(batch), params.ctypes.data, stream,
        )
    _build.check(err, "j2_return")
    j2_return.launches += 1
    return stress, ctan, eps_p_new, alpha_new, f_trial, plastic


j2_return.launches = 0
