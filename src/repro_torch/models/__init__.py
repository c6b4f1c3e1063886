from .model import ModelApi, get_model, input_specs, kv_dtype_for_cell

__all__ = ["ModelApi", "get_model", "input_specs", "kv_dtype_for_cell"]
