"""Evaluation and serving."""

from .evaluator import Evaluator, load_weights
from .serve import load_serving_model, serve

__all__ = ["Evaluator", "load_weights", "load_serving_model", "serve"]
