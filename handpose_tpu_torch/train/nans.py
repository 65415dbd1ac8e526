"""``cfg.debug_nans``: name the first module that makes a NaN.

The JAX Worker sets ``jax_debug_nans``, which raises
``FloatingPointError`` at the first operation that outputs a NaN
(``handpose_tpu/train/trainer.py:57-60``).  Here every module of the
model gets a forward hook: while a step watches (:meth:`NanTrap.watch`),
the hook records whether the module's output holds a NaN and hooks the
gradient of its inputs, which the module's backward computes.  The flags
stay on the device until the step's forward and backward are done; then
one read raises ``FloatingPointError`` naming the first module, in
execution order, whose output or input gradient held one, before the
optimizer takes the step.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _tensors(getattr(x, k))


class NanTrap:
    """The NaN flags of one model's modules (:func:`nan_trap` makes one
    per model)."""

    def __init__(self, model: nn.Module):
        self.flags: list = []
        self.watching = False
        for name, m in model.named_modules():
            what = f"{name or type(model).__name__} ({type(m).__name__})"
            m.register_forward_hook(self._hook(what))

    def _hook(self, what: str):
        def record(where):
            def flag(t):
                self.flags.append((f"{where} of {what}",
                                   torch.isnan(t.detach()).any()))
            return flag

        def hook(module, inputs, output):
            if not self.watching:
                return
            for t in _tensors(output):
                if t.is_floating_point():
                    record("the output")(t)
            for t in _tensors(inputs):
                if t.requires_grad:
                    t.register_hook(record("the input gradient"))
        return hook

    @contextmanager
    def watch(self):
        """Record during the block; on its end raise
        ``FloatingPointError`` naming the first NaN recorded."""
        self.flags.clear()
        self.watching = True
        try:
            yield
        finally:
            self.watching = False
        flags, self.flags = self.flags, []
        if flags:
            hit = torch.stack([f for _, f in flags]).cpu()
            if bool(hit.any()):
                first = int(hit.nonzero()[0, 0])
                raise FloatingPointError(
                    f"debug_nans: NaN in {flags[first][0]}")


def nan_trap(model: nn.Module) -> NanTrap:
    """``model``'s trap, hooked on first use."""
    trap = model.__dict__.get("_nan_trap")
    if trap is None:
        trap = model.__dict__["_nan_trap"] = NanTrap(model)
    return trap
