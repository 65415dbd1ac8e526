"""The control, and the planted faults, read at a cell's own size.

The control is the reference put in the measured package's place,
computed in the precision below the one the configuration states
(``control_quant``: its trunk rounded to float8 e4m3, where the
configuration computes it in bfloat16), and compared with the float32
reference by the cell's own comparison: its numbers give the upper
readings the limits are set below.  ``half_batch`` plants a fault in the
reference put in the package's place: each training step on half its
batch, the mean taken over that half.  (A step that leaves the state
unchanged reads 1 in ``change`` by construction.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs
from .drivers import serve as serve_driver, train as train_driver
from .manifest import Manifest

KINDS = {"train": ("control", "half_batch"), "serve": ("control",)}


def readings(cell: str, seed: int, device, which: str = "control",
             config_overrides: dict = None,
             traffic_overrides: dict = None) -> tuple:
    """(numbers, details) of the comparison of cell ``cell`` when
    ``which`` ('control' or 'half_batch') takes the measured package's
    place (details: what the calibration reads beside the numbers of a
    training cell); the overrides serve the harness's own tests."""
    m = Manifest.load()
    w = m.cell(cell)
    c = {**m.config(w["config"]), **(config_overrides or {})}
    t = {**m.traffic(w["traffic"]), **(traffic_overrides or {})}
    dev = torch.device(device)
    if which not in KINDS[t["kind"]]:
        raise ValueError(f"{which!r} is not read for {t['kind']} cells")
    variant = ({"quant": c["control_quant"]} if which == "control"
               else {"half_batch": True})
    if t["kind"] == "train":
        data, w0 = inputs.train(c, t, seed, dev)
        B = t["batch"]
        rows = [np.arange(i * B, (i + 1) * B)
                for i in range(t["checked_steps"])]
        spe = t["samples"] // B
        prog = train_driver.by_reference(c, data, w0, rows, spe, dev,
                                         **variant)
        return train_driver.check(c, data, w0, rows, spe, dev, prog)
    samples, cuts, w0 = inputs.serve(c, t, seed, dev)
    got = [(i, xyz, uv) for i, (xyz, uv) in enumerate(
        serve_driver.by_reference(c, samples, cuts, w0, dev, **variant))]
    return serve_driver.check(c, samples, cuts, w0, dev, got), {}
