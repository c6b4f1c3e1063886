from .model import ModelApi, get_model

__all__ = ["ModelApi", "get_model"]
