"""2-D image denoising diffusion: Unet2D and the generic GaussianDiffusion.

Port of ``handpose_tpu/nn/diffusion2d.py`` (the reference's image-DDPM
example, example/diffusionExample.py:189-573): :class:`GaussianDiffusion`
is :class:`~handpose_tpu_torch.nn.diffusion.GaussianDiffusion1D` on any
data shape; ``Unet2D`` takes and returns (B, H, W, C) as the JAX module
does and works in (B, C, H, W) inside; JAX's ``Block2D`` is
``diffusion.Block`` with ``ndim=2``.  Its x2 upsample repeats each pixel
twice along both axes, which is ``jax.image.resize(..., 'nearest')`` at
an exact factor of 2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import (Attention, Block, ConvNd, GaussianDiffusion1D,
                        Linear, RMSNorm, sinusoidal_pos_emb)


class GaussianDiffusion(GaussianDiffusion1D):
    """Schedule and samplers for data of shape ``data_shape`` (images
    (H, W, C) etc.)."""

    def __init__(self, data_shape: Tuple[int, ...], **kw):
        super().__init__(seq_length=1, channels=1, **kw)
        self.data_shape = tuple(data_shape)

    def sample(self, denoise_fn, batch_size, condition,
               generator: Optional[torch.Generator] = None,
               clip_denoised: bool = True, init_noise=None, step_noise=None):
        shape = (batch_size,) + self.data_shape
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(denoise_fn, shape, condition, generator, clip_denoised,
                  init_noise, None, step_noise)


class ResnetBlock2D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_dim: int,
                 groups: int = 8):
        super().__init__()
        self.time_proj = Linear(time_dim, dim_out * 2)
        self.block1 = Block(dim, dim_out, groups, ndim=2)
        self.block2 = Block(dim_out, dim_out, groups, ndim=2)
        self.res_conv = (ConvNd(dim, dim_out, 1, ndim=2) if dim != dim_out
                         else None)

    def forward(self, x, t=None):
        scale_shift = None
        if t is not None:
            h = self.time_proj(F.silu(t))[:, :, None, None]
            scale_shift = h.chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + (x if self.res_conv is None else self.res_conv(x))


class Unet2D(nn.Module):
    """Compact image UNet denoiser; ``forward(x (B, H, W, C), time (B,),
    condition (B, F) or None) -> (B, H, W, C)``."""

    def __init__(self, dim: int = 32, dim_mults: Sequence[int] = (1, 2, 4),
                 channels: int = 3, condition_feat_dim: Optional[int] = None,
                 groups: int = 8):
        super().__init__()
        self.dim = dim
        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        n = len(self.in_out)

        self.init_conv = ConvNd(channels, dim, 7, ndim=2, padding=3)
        self.time_mlp_1 = Linear(dim, time_dim)
        self.time_mlp_2 = Linear(time_dim, time_dim)
        if condition_feat_dim is not None:
            self.cond_mlp_1 = Linear(condition_feat_dim, time_dim)
            self.cond_mlp_2 = Linear(time_dim, time_dim)
        for i, (d_in, d_out) in enumerate(self.in_out):
            self.add_module(f"down_{i}_block",
                            ResnetBlock2D(d_in, d_in, time_dim, groups))
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", ConvNd(
                    d_in, d_out, 4, ndim=2, stride=2, padding=1))
            else:
                self.add_module(f"down_{i}_conv", ConvNd(
                    d_in, d_out, 3, ndim=2, padding=1))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock2D(mid, mid, time_dim, groups)
        self.mid_norm = RMSNorm(mid)
        self.mid_attn = Attention(mid)
        self.mid_block2 = ResnetBlock2D(mid, mid, time_dim, groups)
        for i, (d_in, d_out) in enumerate(reversed(self.in_out)):
            self.add_module(f"up_{i}_block", ResnetBlock2D(
                d_out + d_in, d_out, time_dim, groups))
            name = f"up_{i}_upsample_conv" if i < n - 1 else f"up_{i}_conv"
            self.add_module(name, ConvNd(d_out, d_in, 3, ndim=2, padding=1))
        self.final_res_block = ResnetBlock2D(dim * 2, dim, time_dim, groups)
        self.final_conv = ConvNd(dim, channels, 1, ndim=2)

    def forward(self, x, time, condition=None):
        n = len(self.in_out)
        x = self.init_conv(x.permute(0, 3, 1, 2))        # (B, C, H, W)
        r = x
        dtype = self.time_mlp_1.weight.dtype
        t = sinusoidal_pos_emb(time, self.dim, dtype=dtype).to(dtype)
        t = self.time_mlp_2(F.gelu(self.time_mlp_1(t)))
        if condition is not None:
            t = t + self.cond_mlp_2(F.gelu(self.cond_mlp_1(condition)))

        h = []
        for i in range(n):
            x = getattr(self, f"down_{i}_block")(x, t)
            h.append(x)
            x = getattr(self, f"down_{i}_downsample" if i < n - 1
                        else f"down_{i}_conv")(x)
        x = self.mid_block1(x, t)
        B, C, H, W = x.shape
        flat = x.reshape(B, C, H * W)
        x = x + self.mid_attn(self.mid_norm(flat)).reshape(x.shape)
        x = self.mid_block2(x, t)
        for i in range(n):
            x = getattr(self, f"up_{i}_block")(
                torch.cat([x, h.pop()], dim=1), t)
            if i < n - 1:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = getattr(self, f"up_{i}_upsample_conv")(x)
            else:
                x = getattr(self, f"up_{i}_conv")(x)
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x).permute(0, 2, 3, 1)
