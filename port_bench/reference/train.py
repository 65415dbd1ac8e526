"""Training steps of the reference, plain: Adam (betas 0.9/0.999, eps
1e-8) under the reference's cosine learning rate stepped once per epoch
(``CosineAnnealingLR(T_max=max_epoch, eta_min)``), on the trainer-B
loss, with train-mode BatchNorm (the batch's own statistics)."""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch

from . import preprocess as pre


def cosine_lr(step: int, cfg: dict, steps_per_epoch: int) -> float:
    """The rate of the update after ``step`` updates."""
    epoch = min(step // max(steps_per_epoch, 1), cfg["max_epoch"])
    base, low = cfg["lr"], cfg["lr_min"]
    return low + (base - low) * (1 + math.cos(math.pi * epoch
                                              / cfg["max_epoch"])) / 2


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@exact_f32()
def steps(net, weights: dict, raws: List[tuple], cfg: dict,
          steps_per_epoch: int, quant=None,
          half_batch: bool = False) -> dict:
    """``len(raws)`` training steps from ``weights`` (flax paths ->
    float32 tensors) on the raw batches ``raws``; ``net`` is the
    configuration's reference module (``forward``, ``losses``).

    Returns ``losses`` (each step's total), ``grad1`` (the first step's
    gradient of every parameter) and ``params`` (every parameter after
    the last step).  ``half_batch`` trains on the first half of each
    batch: a planted fault, for reading the comparison's upper ends.
    """
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if k.startswith("params/")}
    stats = {k: v for k, v in weights.items() if not k.startswith("params/")}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"losses": [], "grad1": None}
    for t, raw in enumerate(raws, 1):
        if half_batch:
            raw = tuple(a[:a.shape[0] // 2] for a in raw)
        with torch.no_grad():
            pp = pre.preprocess(raw, cfg["crop"], cfg["sigma"])
        loss = net.losses(net.forward({**params, **stats}, pp, cfg, True,
                                      quant), pp)["loss"]
        grads = torch.autograd.grad(loss, list(params.values()))
        out["losses"].append(float(loss.detach()))
        lr = cosine_lr(t - 1, cfg, steps_per_epoch)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (s[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
        if t == 1:
            out["grad1"] = {k: g.detach() for k, g in zip(params, grads)}
        del grads, pp, loss
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out


@exact_f32()
def serve(net, weights: dict, raw: tuple, cfg: dict, quant=None,
          rows: int = 64) -> tuple:
    """(xyz, uv) of the eval-mode network on ``raw``, in blocks of
    ``rows``: eval-mode BatchNorm keeps no statistics of the batch, so
    blocks give what the whole batch gives."""
    xyz, uv = [], []
    with torch.no_grad():
        for i in range(0, raw[0].shape[0], rows):
            part = tuple(a[i:i + rows] for a in raw)
            pp = pre.preprocess(part, cfg["crop"], cfg["sigma"])
            a, b = net.served(net.forward(weights, pp, cfg, False, quant), pp)
            xyz.append(a)
            uv.append(b)
    return torch.cat(xyz), torch.cat(uv)

