import torch

from macroc_tpu_torch.constitutive.base import ConstitutiveEngine, HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import ElasticEngine, elastic_matrix
from macroc_tpu_torch.constitutive.j2 import J2Engine, J2State


def engine_kind(cfg) -> str:
    """The engine cfg.constitutive names.  "auto" routes by the physics the
    flags describe: when the two materials differ AND the micro geometry
    places material 2 somewhere, only the micro-FE engine is faithful;
    otherwise the RVE is effectively homogeneous and the closed-form J2
    engine is exact."""
    kind = cfg.constitutive
    if kind == "auto":
        from macroc_tpu_torch.constitutive.microfe import material2_mask

        hetero = cfg.micro_mat_1 != cfg.micro_mat_2 and bool(
            material2_mask(cfg.micro_n, cfg.micro_type, cfg.micro_params).any()
        )
        kind = "microfe" if hetero else "j2"
    return kind


def make_engine(cfg, dtype: torch.dtype, device: torch.device):
    """Engine factory from MacroConfig (``engine_kind``)."""
    kind = engine_kind(cfg)
    if kind == "elastic":
        return ElasticEngine(cfg.micro_mat_1, dtype=dtype, device=device)
    if kind == "j2":
        return J2Engine(cfg.micro_mat_1, dtype=dtype, device=device)
    if kind == "microfe":
        from macroc_tpu_torch.constitutive.microfe import MicroFEEngine

        return MicroFEEngine(
            n=cfg.micro_n,
            micro_type=cfg.micro_type,
            mat1=cfg.micro_mat_1,
            mat2=cfg.micro_mat_2,
            params=cfg.micro_params,
            dtype=dtype,
            device=device,
            elastic_fastpath=cfg.micro_elastic_fastpath,
            precond=cfg.micro_precond,
            active_chunk=cfg.micro_active_chunk,
        )
    raise ValueError(f"unknown constitutive engine '{kind}'")


__all__ = [
    "ConstitutiveEngine",
    "ElasticEngine",
    "HomogenizeResult",
    "J2Engine",
    "J2State",
    "elastic_matrix",
    "engine_kind",
    "make_engine",
]
