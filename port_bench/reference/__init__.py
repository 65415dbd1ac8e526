"""The plain reference: float32 PyTorch (TF32 off on the card), with no
kernel of its own and nothing of ``handpose_tpu_torch``.

* ``synth``: the RHD-shaped samples made from the seed (the inputs both
  sides get) and the writer of their RHD tree;
* ``preprocess``: the RHD preprocessing of the serving and training
  paths (dominant hand, crop, canonical frame, scoremaps);
* ``model``: the two configurations' networks on flax-path weights;
* ``train``: the trainer-B losses, Adam and the cosine schedule.
"""

import importlib


def module(config: dict):
    """The reference module a configuration names (``reference/<name>.py``,
    its ``reference`` key): ``spec``, ``forward``, ``losses``,
    ``served``."""
    return importlib.import_module(f"{__name__}.{config['reference']}")
