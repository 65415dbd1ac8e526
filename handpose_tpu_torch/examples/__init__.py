"""Standalone demos: ``python -m handpose_tpu_torch.examples.diffusion1d``,
``... .diffusion2d`` and ``... .serving_demo``."""
