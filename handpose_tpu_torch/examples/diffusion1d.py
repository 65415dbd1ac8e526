"""Standalone conditional 1-D diffusion demo.

    python -m handpose_tpu_torch.examples.diffusion1d [--steps 200]
        [--batch 32] [--timesteps 100] [--device cuda|cpu]

Port of ``examples/diffusion1d_demo.py`` (reference
example/GaussianDiffusion1DExample.py:16-114): trains a small conditional
Unet1D (``DiffusionJointEstimation``, dim 32) with Adam to denoise
synthetic 1-D signals whose shape depends on a condition vector, then
samples with DDIM and reports the mean |sample - truth|.  Draws come from
one generator on the device, seeded 0.  About a minute on the host.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..device import resolve_device
from ..models.zoo import init_parameters
from ..nn.diffusion import DiffusionJointEstimation


def synth_batch(generator: torch.Generator, batch: int, seq_len: int = 63,
                cond_dim: int = 16):
    """Signals: a mixture of two sinusoids whose frequencies and phases
    are written into the condition vector; (B, 1, L) in [0, 1], (B, C)."""
    dev = generator.device
    freq = torch.rand((batch, 2), generator=generator, device=dev) * 3 + 1
    phase = torch.rand((batch, 2), generator=generator,
                       device=dev) * 2 * math.pi
    t = torch.linspace(0, 1, seq_len, device=dev)[None, :]
    x = 0.5 * (torch.sin(2 * math.pi * freq[:, :1] * t + phase[:, :1]) +
               torch.sin(2 * math.pi * freq[:, 1:] * t + phase[:, 1:]))
    cond = torch.cat([freq, phase, torch.zeros((batch, cond_dim - 4),
                                               device=dev)], dim=1)
    return ((x + 1) / 2)[:, None, :], cond        # diffusion works in [0, 1]


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cond_dim = 16
    model = init_parameters(DiffusionJointEstimation(
        condition_feat_dim=cond_dim, num_timesteps=args.timesteps,
        num_sampling_timesteps=args.timesteps // 2, dim=32), seed=0).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(args.steps):
        x0, cond = synth_batch(gen, args.batch)
        loss = model(x0, cond, gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss.detach()):.4f}")

    # sample conditioned on held-out conditions, compare to ground truth
    x_true, cond = synth_batch(gen, 8)
    x_samp = model.sample(cond, gen)
    err = float(torch.mean(torch.abs(x_samp - x_true)))
    print(f"mean |sample - truth| after {args.steps} steps: {err:.4f} "
          f"(untrained baseline ~0.35)")
    return err


if __name__ == "__main__":
    main()
