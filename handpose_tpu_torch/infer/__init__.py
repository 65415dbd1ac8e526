"""Evaluation, serving and the exported serving artifacts
(``infer.export``).

Names are imported on first use, so that a serving process that imports
only ``handpose_tpu_torch.infer.export`` to load an artifact loads no
model, config or training module.
"""

__all__ = ["Evaluator", "load_weights", "model_name_from_path",
           "load_serving_model", "serve"]

_LAZY = {"Evaluator": "evaluator", "load_weights": "evaluator",
         "model_name_from_path": "evaluator",
         "load_serving_model": "serving", "serve": "serving"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
