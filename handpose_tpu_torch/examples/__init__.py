"""Standalone demos: ``python -m handpose_tpu_torch.examples.diffusion1d``
and ``python -m handpose_tpu_torch.examples.diffusion2d``."""
