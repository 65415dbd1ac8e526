"""Evaluation and serving."""

from .evaluator import Evaluator, load_weights, model_name_from_path
from .serve import load_serving_model, serve

__all__ = ["Evaluator", "load_weights", "model_name_from_path",
           "load_serving_model", "serve"]
