"""Constitutive-engine protocol — the MicroPP call boundary, made functional
(torch form of ``macroc_tpu/constitutive/base.py``).

``homogenize`` computes the trial response from the COMMITTED state without
mutating it; committing is the caller assigning ``trial_state`` (reference
main.c:62 vs 83).  State tensors are batched over Gauss points with leading
shape (nx, ny, nz, 8).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Protocol, Tuple

import torch


class HomogenizeResult(NamedTuple):
    stress: torch.Tensor      # (..., 6) Voigt stress at each GP
    ctan: torch.Tensor        # (..., 6, 6) consistent tangent at each GP
    trial_state: Any          # state to commit at update_vars
    non_linear: torch.Tensor  # (...,) bool
    f_trial: torch.Tensor     # (...,)
    cost: torch.Tensor        # (...,)
    # (...,) bool: inner solve hit its cap (micro-FE); None for closed forms
    unconverged: Any = None


class ConstitutiveEngine(Protocol):
    #: True when every ctan is symmetric to roundoff, so the assembled
    #: operator is too and the fused CG may apply it from its upper half
    symmetric_tangent: bool

    def init_state(self, batch_shape: Tuple[int, ...]) -> Any:
        """Fresh internal-variable state with leading dims batch_shape."""
        ...

    def homogenize(self, eps: torch.Tensor, state: Any) -> HomogenizeResult:
        """Pure trial response: eps (..., 6) engineering Voigt strain."""
        ...
