"""Isotropic linear-elastic constitutive engine (torch form of
``macroc_tpu/constitutive/elastic.py``): sigma = C eps, ctan = C, no
internal variables."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from macroc_tpu_torch.config import MaterialParams
from macroc_tpu_torch.constitutive.base import HomogenizeResult


def elastic_matrix(mat: MaterialParams) -> np.ndarray:
    """6x6 isotropic stiffness, engineering Voigt (xx,yy,zz,xy,xz,yz):
    sigma = C @ eps_eng (shear rows are mu * gamma)."""
    lam, mu = mat.lam, mat.mu
    C = np.zeros((6, 6), dtype=np.float64)
    C[:3, :3] = lam
    C[0, 0] = C[1, 1] = C[2, 2] = lam + 2.0 * mu
    C[3, 3] = C[4, 4] = C[5, 5] = mu
    return C


class ElasticEngine:
    #: every tangent is the elastic matrix, symmetric
    symmetric_tangent = True

    def __init__(self, mat: MaterialParams, dtype: torch.dtype,
                 device: torch.device):
        self.mat = mat
        self.dtype = dtype
        self.device = device
        self._C = torch.as_tensor(elastic_matrix(mat), dtype=dtype, device=device)

    def init_state(self, batch_shape: Tuple[int, ...]):
        return ()  # no internal variables

    def homogenize(self, eps, state) -> HomogenizeResult:
        stress = eps @ self._C.T
        batch = eps.shape[:-1]
        zeros = torch.zeros(batch, dtype=self.dtype, device=self.device)
        return HomogenizeResult(
            stress=stress,
            ctan=self._C.expand(batch + (6, 6)),
            trial_state=(),
            non_linear=torch.zeros(batch, dtype=torch.bool, device=self.device),
            f_trial=zeros,
            cost=zeros,
        )
