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
dtype: a float32 run stays float32 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from macroc_tpu.config import MaterialParams
from macroc_tpu_torch.constitutive.base import HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import elastic_matrix

_SQ23 = float(np.sqrt(2.0 / 3.0))


@dataclasses.dataclass(frozen=True)
class J2State:
    eps_p: torch.Tensor  # (..., 6)
    alpha: torch.Tensor  # (...,)


class J2Engine:
    def __init__(self, mat: MaterialParams, dtype: torch.dtype,
                 device: torch.device):
        self.mat = mat
        self.dtype = dtype
        self.device = device
        self._C = torch.as_tensor(elastic_matrix(mat), dtype=dtype, device=device)
        ones33 = np.zeros((6, 6))
        ones33[:3, :3] = 1.0
        i_dev = np.diag([1, 1, 1, 0.5, 0.5, 0.5]) - ones33 / 3.0
        self._ones33 = torch.as_tensor(ones33, dtype=dtype, device=device)
        self._i_dev = torch.as_tensor(i_dev, dtype=dtype, device=device)

    def init_state(self, batch_shape: Tuple[int, ...]) -> J2State:
        z = dict(dtype=self.dtype, device=self.device)
        return J2State(
            eps_p=torch.zeros(batch_shape + (6,), **z),
            alpha=torch.zeros(batch_shape, **z),
        )

    def homogenize(self, eps: torch.Tensor, state: J2State) -> HomogenizeResult:
        mat = self.mat
        mu, lam, Ka, Sy = mat.mu, mat.lam, mat.Ka, mat.Sy
        kappa = lam + 2.0 * mu / 3.0

        e = eps - state.eps_p
        sig_tr = e @ self._C.T

        p = (sig_tr[..., 0] + sig_tr[..., 1] + sig_tr[..., 2]) / 3.0
        s = sig_tr.clone()
        s[..., :3] -= p[..., None]
        snorm = torch.sqrt(
            torch.sum(s[..., :3] ** 2, dim=-1)
            + 2.0 * torch.sum(s[..., 3:] ** 2, dim=-1)
        )
        f_trial = snorm - _SQ23 * (Sy + Ka * state.alpha)
        plastic = f_trial > 0.0

        dgamma = torch.where(
            plastic, f_trial / (2.0 * mu + (2.0 / 3.0) * Ka), 0.0
        )
        safe = torch.clamp_min(snorm, 1e-30)
        n = s / safe[..., None]

        stress = sig_tr - (2.0 * mu * dgamma)[..., None] * n

        # engineering plastic-strain increment: shear entries doubled
        dn = n.clone()
        dn[..., 3:] *= 2.0
        eps_p_new = state.eps_p + dgamma[..., None] * dn
        alpha_new = state.alpha + _SQ23 * dgamma

        # consistent tangent, summed in the reference's order:
        # (kappa 1x1 + 2mu theta I_dev) - (2mu thetabar) n x n
        theta = 1.0 - 2.0 * mu * dgamma / safe
        thetabar = 1.0 / (1.0 + Ka / (3.0 * mu)) - (1.0 - theta)
        C_ep = ((2.0 * mu) * theta)[..., None, None] * self._i_dev
        C_ep += kappa * self._ones33
        nn = n[..., :, None] * n[..., None, :]
        C_ep -= nn.mul_(((2.0 * mu) * thetabar)[..., None, None])
        del nn
        ctan = torch.where(plastic[..., None, None], C_ep, self._C)

        trial = J2State(
            eps_p=torch.where(plastic[..., None], eps_p_new, state.eps_p),
            alpha=torch.where(plastic, alpha_new, state.alpha),
        )
        cost = 1.0 + plastic.to(self.dtype)
        return HomogenizeResult(
            stress=stress,
            ctan=ctan,
            trial_state=trial,
            non_linear=plastic,
            f_trial=f_trial,
            cost=cost,
        )
