from .validator import Validator

__all__ = ["Validator"]
