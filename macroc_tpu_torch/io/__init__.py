from macroc_tpu_torch.io.info import InfoWriter, GaussEvolutionWriter
from macroc_tpu_torch.io.vtu import write_pvtu

__all__ = ["InfoWriter", "GaussEvolutionWriter", "write_pvtu"]
