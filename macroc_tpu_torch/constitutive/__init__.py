import torch

from macroc_tpu_torch.constitutive.base import ConstitutiveEngine, HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import ElasticEngine, elastic_matrix
from macroc_tpu_torch.constitutive.j2 import J2Engine, J2State


def make_engine(cfg, dtype: torch.dtype, device: torch.device):
    """Engine factory from MacroConfig.

    kind="auto" routes by the physics the flags describe: when the two
    materials differ AND the micro geometry places material 2 somewhere,
    only the micro-FE engine is faithful; otherwise the RVE is effectively
    homogeneous and the closed-form J2 engine is exact."""
    kind = cfg.constitutive
    if kind == "auto":
        from macroc_tpu_torch.constitutive.microfe import material2_mask

        hetero = cfg.micro_mat_1 != cfg.micro_mat_2 and bool(
            material2_mask(cfg.micro_n, cfg.micro_type, cfg.micro_params).any()
        )
        kind = "microfe" if hetero else "j2"
    if kind == "elastic":
        return ElasticEngine(cfg.micro_mat_1, dtype=dtype, device=device)
    if kind == "j2":
        return J2Engine(cfg.micro_mat_1, dtype=dtype, device=device)
    if kind == "microfe":
        raise NotImplementedError(
            "the micro-FE (FE²) engine is not ported to macroc_tpu_torch yet "
            "(ROADMAP.md queue 1, micro-FE port); the flags select it because "
            "micro_mat_1 != micro_mat_2 on a heterogeneous micro geometry — "
            "use macroc_tpu for FE² runs"
        )
    raise ValueError(f"unknown constitutive engine '{kind}'")


__all__ = [
    "ConstitutiveEngine",
    "ElasticEngine",
    "HomogenizeResult",
    "J2Engine",
    "J2State",
    "elastic_matrix",
    "make_engine",
]
