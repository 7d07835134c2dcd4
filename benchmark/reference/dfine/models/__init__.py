from .decoder import DFINETransformer
from .dfine import DFINE, build_model
from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder

__all__ = ["HGNetv2", "HybridEncoder", "DFINETransformer", "DFINE", "build_model"]
