"""J2 (von Mises) plasticity with linear isotropic hardening — closed form
(torch form of ``macroc_tpu/constitutive/j2.py``).

Radial-return mapping over all Gauss points at once; exact for the
reference's default micro configuration (micro_mat_1 == micro_mat_2, a
homogeneous RVE).

Internal variables per GP (committed only by update_vars):
  eps_p : (..., 6) plastic strain, engineering Voigt
  alpha : (...,)   equivalent plastic strain

Trial state / return map (Simo–Hughes):
  sigma_tr = C : (eps - eps_p),  s_tr = dev(sigma_tr)
  f_tr     = |s_tr| - sqrt(2/3) (Sy + Ka alpha)
  plastic:  dgamma = f_tr / (2 mu + (2/3) Ka),  n = s_tr/|s_tr|
            sigma  = sigma_tr - 2 mu dgamma n
            eps_p += dgamma * n  (shear entries doubled: engineering)
            alpha += sqrt(2/3) dgamma
Consistent tangent:
  theta    = 1 - 2 mu dgamma / |s_tr|
  thetabar = 1/(1 + Ka/(3 mu)) - (1 - theta)
  C_ep = kappa 1x1 + 2 mu theta I_dev - 2 mu thetabar n x n

Material constants enter as Python floats, which never promote a tensor's
dtype: a float32 run stays float32 on the card.  The micro-FE engine
passes per-element material fields instead (``j2_radial_return``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from macroc_tpu_torch.config import MaterialParams
from macroc_tpu_torch.constitutive.base import HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import elastic_matrix

_SQ23 = float(np.sqrt(2.0 / 3.0))


@dataclasses.dataclass(frozen=True)
class J2State:
    eps_p: torch.Tensor  # (..., 6)
    alpha: torch.Tensor  # (...,)


def _minor(v, k: int):
    """A material parameter broadcast against k trailing minor dims: a
    Python float as it is, a field tensor with k singleton dims added."""
    return v[(...,) + (None,) * k] if torch.is_tensor(v) else v


def j2_radial_return(eps, eps_p, alpha, lam, mu, Sy, Ka, C=None,
                     tangent: bool = True):
    """Functional radial-return map, shared by J2Engine (scalar material)
    and the micro-FE engine (per-micro-element material fields).

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


class J2Engine:
    #: associative J2 with isotropic hardening: the consistent tangent is
    #: symmetric to roundoff
    symmetric_tangent = True

    def __init__(self, mat: MaterialParams, dtype: torch.dtype,
                 device: torch.device):
        self.mat = mat
        self.dtype = dtype
        self.device = device
        self._C = torch.as_tensor(elastic_matrix(mat), dtype=dtype, device=device)

    def init_state(self, batch_shape: Tuple[int, ...]) -> J2State:
        z = dict(dtype=self.dtype, device=self.device)
        return J2State(
            eps_p=torch.zeros(batch_shape + (6,), **z),
            alpha=torch.zeros(batch_shape, **z),
        )

    def homogenize(self, eps: torch.Tensor, state: J2State) -> HomogenizeResult:
        mat = self.mat
        stress, ctan, eps_p, alpha, f_trial, plastic = j2_radial_return(
            eps, state.eps_p, state.alpha, mat.lam, mat.mu, mat.Sy, mat.Ka,
            C=self._C,
        )
        cost = 1.0 + plastic.to(self.dtype)
        return HomogenizeResult(
            stress=stress,
            ctan=ctan,
            trial_state=J2State(eps_p=eps_p, alpha=alpha),
            non_linear=plastic,
            f_trial=f_trial,
            cost=cost,
        )
