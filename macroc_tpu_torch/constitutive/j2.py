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
passes per-element material fields instead
(``ops/j2_return.py::j2_radial_return``, the map's plain version).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from macroc_tpu_torch.config import MaterialParams
from macroc_tpu_torch.constitutive.base import HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.ops.j2_return import j2_return


@dataclasses.dataclass(frozen=True)
class J2State:
    eps_p: torch.Tensor  # (..., 6)
    alpha: torch.Tensor  # (...,)


class J2Engine:
    #: associative J2 with isotropic hardening: the consistent tangent is
    #: symmetric to roundoff
    symmetric_tangent = True

    def __init__(self, mat: MaterialParams, dtype: torch.dtype,
                 device: torch.device):
        self.mat = mat
        self.dtype = dtype
        self.device = device
        self._C = elastic_matrix(mat)  # host array: j2_return's one source of C

    def init_state(self, batch_shape: Tuple[int, ...]) -> J2State:
        z = dict(dtype=self.dtype, device=self.device)
        return J2State(
            eps_p=torch.zeros(batch_shape + (6,), **z),
            alpha=torch.zeros(batch_shape, **z),
        )

    def homogenize(self, eps: torch.Tensor, state: J2State) -> HomogenizeResult:
        """The return map as one kernel on CUDA tensors, its plain version
        on CPU tensors (``ops/j2_return.py``)."""
        stress, ctan, eps_p, alpha, f_trial, plastic = j2_return(
            eps, state.eps_p, state.alpha, self.mat, self._C)
        # 1 + plastic, in place: no second (...,) temporary
        cost = plastic.to(self.dtype).add_(1.0)
        return HomogenizeResult(
            stress=stress,
            ctan=ctan,
            trial_state=J2State(eps_p=eps_p, alpha=alpha),
            non_linear=plastic,
            f_trial=f_trial,
            cost=cost,
        )
