"""A cell's inputs and weights from the seed: the same for the run, its
reference and its control."""

from __future__ import annotations

import numpy as np
import torch

from . import reference, weights as weights_
from .reference import synth


def host(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def train(config: dict, traffic: dict, seed: int, device) -> tuple:
    """(samples, weights) as host arrays: ``samples`` + ``eval_samples``
    samples made on the device a batch at a time, then the weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, step = traffic["samples"] + traffic["eval_samples"], traffic["batch"]
    parts = [host(synth.make_samples(min(step, n - i), gen))
             for i in range(0, n, step)]
    data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return data, host(weights_.make(reference.module(config).spec(config),
                                    gen))


def serve(config: dict, traffic: dict, seed: int, device) -> tuple:
    """(samples on the device, the pool's batch slices, host weights)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B = traffic["batch"]
    samples = synth.make_samples(traffic["pool"] * B, gen)
    cuts = [slice(i * B, (i + 1) * B) for i in range(traffic["pool"])]
    return samples, cuts, host(weights_.make(
        reference.module(config).spec(config), gen))


def on(device, data: dict, rows=None) -> tuple:
    """An RHD raw batch (the reference's tuple) of host ``data``'s
    ``rows`` on ``device``."""
    return synth.raw_fields({k: torch.from_numpy(
        v if rows is None else v[rows]).to(device) for k, v in data.items()})
