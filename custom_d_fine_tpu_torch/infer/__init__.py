from .model import TorchModel

__all__ = ["TorchModel"]
