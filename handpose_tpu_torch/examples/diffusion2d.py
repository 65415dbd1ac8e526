"""Standalone image-DDPM demo.

    python -m handpose_tpu_torch.examples.diffusion2d [--steps 300]
        [--batch 32] [--timesteps 50] [--fid N] [--device cuda|cpu]

Port of ``examples/diffusion2d_demo.py`` (reference
example/diffusionExample.py): trains a small ``Unet2D`` (dim 24, mults
1/2/4) with Adam on synthetic 16x16 gradient and stripe images and
samples with the ancestral DDPM loop; ``--fid N`` then samples N images
and reports the Frechet distance to N fresh real images and to uniform
noise, on the random-conv proxy features (``utils/fid.py``).  Draws come
from one generator on the device, seeded 0.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..device import resolve_device
from ..models.zoo import init_parameters
from ..nn.diffusion2d import GaussianDiffusion, Unet2D


def synth_images(generator: torch.Generator, batch: int, size: int = 16):
    """Diagonal gradients with random orientation and stripe frequency,
    (B, S, S, 3) in [0, 1]."""
    dev = generator.device
    ang = torch.rand((batch,), generator=generator, device=dev) * math.pi
    freq = torch.rand((batch,), generator=generator, device=dev) * 2 + 1
    lin = torch.linspace(0, 1, size, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    proj = (xx[None] * torch.cos(ang)[:, None, None] +
            yy[None] * torch.sin(ang)[:, None, None])
    img = 0.5 + 0.5 * torch.sin(2 * math.pi * freq[:, None, None] * proj)
    return torch.stack([img, 1 - img, img ** 2], dim=-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timesteps", type=int, default=50)
    ap.add_argument("--fid", type=int, default=0, metavar="N",
                    help="after training, sample N images and report the "
                         "Frechet distance to N fresh real images "
                         "(random-conv proxy features; see utils/fid.py)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    net = init_parameters(Unet2D(dim=24, dim_mults=(1, 2, 4), channels=3),
                          seed=0).to(dev)
    gd = GaussianDiffusion((16, 16, 3), timesteps=args.timesteps)
    opt = torch.optim.Adam(net.parameters(), lr=3e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(args.steps):
        loss = gd.loss(net, synth_images(gen, args.batch), None, gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss.detach()):.4f}")

    samples = gd.sample(net, 4, None, gen)
    print("sampled", tuple(samples.shape), "range",
          float(samples.min()), float(samples.max()))
    res = {"loss": float(loss.detach()), "samples": samples}
    if args.fid:
        from ..utils.fid import fid_score

        n = args.fid
        fake = gd.sample(net, n, None, gen)
        real = synth_images(gen, n)
        noise = torch.rand(real.shape, generator=gen, device=dev)
        res["fid"] = fid_score(fake, real)
        res["fid_noise"] = fid_score(noise, real)
        print(f"FID(gen, real)   = {res['fid']:8.3f}  "
              "(random-conv proxy features)")
        print(f"FID(noise, real) = {res['fid_noise']:8.3f}  "
              "(uninformed baseline, should be much larger)")
    return res


if __name__ == "__main__":
    main()
