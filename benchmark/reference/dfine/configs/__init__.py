from .registry import MODELS, ModelConfig, get_model_config

__all__ = ["MODELS", "ModelConfig", "get_model_config"]
