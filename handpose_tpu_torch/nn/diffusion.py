"""Conditional 1-D denoising diffusion: Unet1D and GaussianDiffusion1D.

Port of ``handpose_tpu/nn/diffusion.py``: the layers (:37-178), ``Unet1D``
(:180-316) with its three modes, the schedules (:319-394, numpy code
kept as it is, so every buffer equals JAX's bit for bit),
``GaussianDiffusion1D`` (:396-662) with the training loss and the DDIM
and ancestral DDPM samplers, and ``DiffusionJointEstimation``
(:665-724).  Submodules carry flax's names, so
``convert.load_flax_variables`` maps each path one to one.

Layouts: ``Unet1D`` takes and returns (B, L, C) as the JAX module does;
inside it works in (B, C, L) for ``conv1d`` (with C = 1 the two are the
same memory).  The denoiser runs in its parameters' dtype, float32,
whatever the model's compute dtype is, as in JAX (``fc_proj`` returns
float32 and the UNet's parameters are float32).

The samplers are Python loops under ``torch.no_grad()`` over per-step
coefficient tables built once per call in numpy float32 (JAX folds the
same tables into its ``lax.scan``), moved to the device as float32
tensors and indexed per step.  Random draws come from an explicit
``torch.Generator`` on the batch's device; the tests inject x_T
(``init_noise``) and the per-step noise (``step_noise``) instead.  JAX's
``scan_unroll`` restructures its ``lax.scan`` and has no eager
counterpart.

Flax's GroupNorm is not ``F.group_norm``: its variance is the one-pass
E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance=True``), eps 1e-5 here;
:class:`GroupNorm` computes that.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import _variance_scaling_


class Linear(nn.Module):
    """flax ``nn.Dense`` in the parameters' dtype: LeCun-normal kernel
    (out, in), zero bias, ``x @ W^T + b`` over the last axis."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            _variance_scaling_(self.weight, 1.0, self.weight.shape[1],
                               generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class ConvNd(nn.Module):
    """flax ``nn.Conv`` with a bias on (B, C, *spatial) tensors, 1-D or
    2-D by ``ndim``: LeCun-normal kernel (out, in, *k), zero bias,
    symmetric ``padding``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 ndim: int = 1, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = F.conv1d if ndim == 1 else F.conv2d
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *(kernel,) * ndim))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            _variance_scaling_(self.weight, 1.0, self.weight[0].numel(),
                               generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias, self.stride,
                         self.padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on (B, C, *spatial):
    per sample and group, mean E[x] and the one-pass variance
    max(E[x^2] - E[x]^2, 0) over the group's channels and positions; then
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.groups
        xg = x.reshape(B, G, C // G, -1)
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(2, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, G, C // G, 1)
        y = torch.addcmul(self.bias.view(1, G, C // G, 1), xg - mean, mul)
        return y.view(x.shape)


class RMSNorm(nn.Module):
    """x / max(|x|_2 over channels, 1e-12) * g * sqrt(C) on (B, C, L);
    ``g`` keeps flax's (1, 1, C) shape."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = math.sqrt(dim)
        self.g = nn.Parameter(torch.ones(1, 1, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.g.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        normed = x / torch.clamp_min(norm, 1e-12)
        return normed * self.g.view(1, -1, 1) * self.scale


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, theta: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N,) times -> (N, dim) [sin, cos] embedding, in float32 (JAX's
    cast), or in ``dtype`` where that is wider: a float64 model is a
    rounding reference all through."""
    dtype = torch.promote_types(torch.float32, dtype)
    half = dim // 2
    emb = math.log(theta) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=t.device,
                                   dtype=dtype) * -emb)
    ang = t.to(dtype)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _nearest_resize_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch ``nn.Upsample(mode='nearest')`` on (B, C, L): the source of
    output i is i * L // out_len, by integer index (``F.interpolate``'s
    float scale can pick another source)."""
    L = x.shape[-1]
    idx = torch.arange(out_len, device=x.device) * L // out_len
    return x.index_select(-1, idx)


class Block(nn.Module):
    """conv3 -> GroupNorm -> optional (scale + 1, shift) -> SiLU, 1-D or
    (``ndim=2``, ``diffusion2d.Block2D``) 2-D."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 ndim: int = 1):
        super().__init__()
        self.proj = ConvNd(dim, dim_out, 3, ndim=ndim, padding=1)
        self.norm = GroupNorm(groups, dim_out)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two ``Block``s with the time projection's scale and shift on the
    first, and a 1x1 ``res_conv`` when the width changes.  Three modes
    (``handpose_tpu/nn/diffusion.py:91-112``): ``time_emb`` (B, T); an
    injected ``time_proj`` (B|1, 2 dim_out), this block's precomputed
    ``Dense(silu(time_emb))``; and ``x=None``, which returns that
    projection for ``time_emb`` of any leading shape."""

    def __init__(self, dim: int, dim_out: int, time_dim: int,
                 groups: int = 8):
        super().__init__()
        self.time_proj = Linear(time_dim, dim_out * 2)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = (ConvNd(dim, dim_out, 1) if dim != dim_out
                         else None)

    def forward(self, x, time_emb=None, time_proj=None):
        if x is None:
            return self.time_proj(F.silu(time_emb))
        scale_shift = None
        if time_proj is None and time_emb is not None:
            time_proj = self.time_proj(F.silu(time_emb))
        if time_proj is not None:
            scale_shift = time_proj[..., None].chunk(2, dim=-2)
        h = self.block2(self.block1(x, scale_shift))
        return h + (x if self.res_conv is None else self.res_conv(x))


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, H*D, L) -> (B, H, D, L)."""
    B, _, L = t.shape
    return t.view(B, heads, -1, L)


class LinearAttention(nn.Module):
    """q softmaxed over d, k over n; context = k v^T, out = context^T q;
    1x1 ``to_out`` and an ``out_norm`` RMSNorm."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = ConvNd(dim, hidden * 3, 1, bias=False)
        self.to_out = ConvNd(hidden, dim, 1)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q = torch.softmax(q, dim=-2) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)   # (B, H, E, L)
        return self.out_norm(self.to_out(out.reshape(B, -1, L)))


class Attention(nn.Module):
    """Full softmax attention over positions; 1x1 ``to_out``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = ConvNd(dim, hidden * 3, 1, bias=False)
        self.to_out = ConvNd(hidden, dim, 1)

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q = q * (self.dim_head ** -0.5)
        sim = torch.einsum("bhdi,bhdj->bhij", q, k)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v)      # (B, H, D, L)
        return self.to_out(out.reshape(B, -1, L))


class PreNormResidual(nn.Module):
    """attn(RMSNorm(x)) + x, linear or full attention."""

    def __init__(self, dim: int, kind: str = "linear", heads: int = 4,
                 dim_head: int = 32):
        super().__init__()
        self.norm = RMSNorm(dim)
        cls = LinearAttention if kind == "linear" else Attention
        self.attn = cls(dim, heads, dim_head)

    def forward(self, x):
        return self.attn(self.norm(x)) + x


class Unet1D(nn.Module):
    """1-D UNet denoiser (reference conditionalDiffusion.py:309-458);
    ``forward(x (B, L, C), time (B,), condition (B, F) or None,
    time_tables=None) -> (B, L, C)``.

    Two more modes serve the hoisted samplers, as in JAX:

    * ``x=None``: ``time`` is the (S,) ladder of every sampling step;
      returns ``{block name: (S, B|1, 2 dim_out)}``, every time-conditioned
      block's time projection batched over the steps, in
      :meth:`block_specs` order;
    * ``time_tables={name: (B|1, 2 dim_out)}``: one step's slices of those
      tables; the time and condition MLPs and every block's time
      projection are skipped.
    """

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 1, condition_feat_dim: Optional[int] = None,
                 resnet_block_groups: int = 8, attn_heads: int = 4,
                 attn_dim_head: int = 32):
        super().__init__()
        self.dim, self.channels = dim, channels
        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        g, heads, dh = resnet_block_groups, attn_heads, attn_dim_head

        self.init_conv = ConvNd(channels, dim, 7, padding=3)
        self.time_mlp_1 = Linear(dim, time_dim)
        self.time_mlp_2 = Linear(time_dim, time_dim)
        if condition_feat_dim is not None:
            self.cond_mlp_1 = Linear(condition_feat_dim, time_dim)
            self.cond_mlp_2 = Linear(time_dim, time_dim)
        self.has_condition = condition_feat_dim is not None
        n = len(self.in_out)
        for ind, (dim_in, dim_out) in enumerate(self.in_out):
            self.add_module(f"down_{ind}_block1",
                            ResnetBlock(dim_in, dim_in, time_dim, g))
            self.add_module(f"down_{ind}_block2",
                            ResnetBlock(dim_in, dim_in, time_dim, g))
            self.add_module(f"down_{ind}_attn",
                            PreNormResidual(dim_in, "linear", heads, dh))
            if ind < n - 1:
                self.add_module(f"down_{ind}_downsample",
                                ConvNd(dim_in, dim_out, 4, stride=2,
                                       padding=1))
            else:
                self.add_module(f"down_{ind}_conv",
                                ConvNd(dim_in, dim_out, 3, padding=1))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, g)
        self.mid_attn = PreNormResidual(mid, "full", heads, dh)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, g)
        for ind, (dim_in, dim_out) in enumerate(reversed(self.in_out)):
            self.add_module(f"up_{ind}_block1", ResnetBlock(
                dim_out + dim_in, dim_out, time_dim, g))
            self.add_module(f"up_{ind}_block2", ResnetBlock(
                dim_out + dim_in, dim_out, time_dim, g))
            self.add_module(f"up_{ind}_attn",
                            PreNormResidual(dim_out, "linear", heads, dh))
            name = (f"up_{ind}_upsample_conv" if ind < n - 1
                    else f"up_{ind}_conv")
            self.add_module(name, ConvNd(dim_out, dim_in, 3, padding=1))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, g)
        self.final_conv = ConvNd(dim, channels, 1)

    def block_specs(self):
        """Names of the time-conditioned ResnetBlocks, in declaration
        order (JAX's ``_block_specs``)."""
        names = []
        for ind in range(len(self.in_out)):
            names += [f"down_{ind}_block1", f"down_{ind}_block2"]
        names += ["mid_block1", "mid_block2"]
        for ind in range(len(self.in_out)):
            names += [f"up_{ind}_block1", f"up_{ind}_block2"]
        return names + ["final_res_block"]

    def _time_embedding(self, time, condition, per_step: bool):
        """The time MLP plus the condition MLP: (N, T), or with
        ``per_step`` (S, B|1, T) for the (S,) ladder ``time``."""
        dtype = self.time_mlp_1.weight.dtype
        t = sinusoidal_pos_emb(time, self.dim, dtype=dtype).to(dtype)
        t = self.time_mlp_2(F.gelu(self.time_mlp_1(t)))
        if condition is not None:
            c = self.cond_mlp_2(F.gelu(self.cond_mlp_1(condition)))
            return t[:, None, :] + c[None, :, :] if per_step else t + c
        return t[:, None, :] if per_step else t

    def forward(self, x, time, condition=None, time_tables=None):
        if x is None:
            t = self._time_embedding(time, condition, per_step=True)
            return {name: getattr(self, name)(None, t)
                    for name in self.block_specs()}
        t = (self._time_embedding(time, condition, per_step=False)
             if time_tables is None else None)

        def block(name, h):
            tp = None if time_tables is None else time_tables[name]
            return getattr(self, name)(h, t, tp)

        x = self.init_conv(x.transpose(1, 2))           # (B, C, L)
        r = x
        h = []
        n = len(self.in_out)
        for ind in range(n):
            x = block(f"down_{ind}_block1", x)
            h.append(x)
            x = block(f"down_{ind}_block2", x)
            x = getattr(self, f"down_{ind}_attn")(x)
            h.append(x)
            x = getattr(self, f"down_{ind}_downsample" if ind < n - 1
                        else f"down_{ind}_conv")(x)
        x = block("mid_block1", x)
        x = self.mid_attn(x)
        x = block("mid_block2", x)
        for ind in range(n):
            x = block(f"up_{ind}_block1", torch.cat([x, h.pop()], dim=1))
            x = block(f"up_{ind}_block2", torch.cat([x, h.pop()], dim=1))
            x = getattr(self, f"up_{ind}_attn")(x)
            if ind < n - 1:
                # CustomUpsample: nearest x2 (+1 when odd), then conv
                L = x.shape[-1]
                x = _nearest_resize_1d(x, L * 2 + L % 2)
                x = getattr(self, f"up_{ind}_upsample_conv")(x)
            else:
                x = getattr(self, f"up_{ind}_conv")(x)
        x = block("final_res_block", torch.cat([x, r], dim=1))
        return self.final_conv(x).transpose(1, 2)       # (B, L, C)


# ---------------------------------------------------------------------------
# schedules: numpy, float64 math and float32 buffers as in JAX


def ddim_time_pairs(total: int, sampling: int) -> np.ndarray:
    """(S, 2) descending (time, time_next) ladder for DDIM: the
    reference's ``torch.linspace(-1, T-1, S+1).int()`` reversed pairing
    (conditionalDiffusion.py:678-681)."""
    times = np.linspace(-1, total - 1, sampling + 1).astype(int)[::-1]
    return np.stack([times[:-1], times[1:]], axis=1)


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps,
                       dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


class DiffusionSchedule:
    """Schedule constants as host numpy float32 arrays (the reference's
    buffers), computed in float64 and cast once."""

    def __init__(self, timesteps: int, beta_schedule: str = "cosine",
                 objective: str = "pred_noise"):
        if beta_schedule == "linear":
            betas = linear_beta_schedule(timesteps)
        elif beta_schedule == "cosine":
            betas = cosine_beta_schedule(timesteps)
        else:
            raise ValueError(f"unknown beta schedule {beta_schedule}")
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        f32 = lambda a: np.asarray(a, np.float32)
        self.betas = f32(betas)
        self.alphas_cumprod = f32(ac)
        self.alphas_cumprod_prev = f32(ac_prev)
        self.sqrt_alphas_cumprod = f32(np.sqrt(ac))
        self.sqrt_one_minus_alphas_cumprod = f32(np.sqrt(1 - ac))
        self.sqrt_recip_alphas_cumprod = f32(np.sqrt(1 / ac))
        self.sqrt_recipm1_alphas_cumprod = f32(np.sqrt(1 / ac - 1))
        pv = betas * (1 - ac_prev) / (1 - ac)
        self.posterior_variance = f32(pv)
        self.posterior_log_variance_clipped = f32(
            np.log(np.maximum(pv, 1e-20)))
        self.posterior_mean_coef1 = f32(betas * np.sqrt(ac_prev) / (1 - ac))
        self.posterior_mean_coef2 = f32(
            (1 - ac_prev) * np.sqrt(alphas) / (1 - ac))
        snr = ac / (1 - ac)
        if objective == "pred_noise":
            lw = np.ones_like(snr)
        elif objective == "pred_x0":
            lw = snr
        elif objective == "pred_v":
            lw = snr / (snr + 1)
        else:
            raise ValueError(f"unknown objective {objective}")
        self.loss_weight = f32(lw)


def _extract(a: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``a[t]`` as a float32 tensor on t's device, shaped to broadcast
    over an ``ndim`` tensor."""
    out = torch.as_tensor(a, device=t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def _on(table: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in table.items()}


class GaussianDiffusion1D:
    """Training loss and DDPM/DDIM sampling around a denoiser
    ``denoise_fn(x (B, L, C), t (B,), condition) -> (B, L, C)``
    (reference conditionalDiffusion.py:467-798, ``auto_normalize=True``:
    [0, 1] <-> [-1, 1])."""

    def __init__(self, seq_length: int, channels: int = 1,
                 timesteps: int = 1000, sampling_timesteps: Optional[int] = None,
                 objective: str = "pred_noise", beta_schedule: str = "cosine",
                 ddim_sampling_eta: float = 0.0, auto_normalize: bool = True):
        self.seq_length = seq_length
        self.channels = channels
        self.num_timesteps = timesteps
        self.sampling_timesteps = (sampling_timesteps if sampling_timesteps
                                   is not None else timesteps)
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.eta = ddim_sampling_eta
        self.objective = objective
        self.sched = DiffusionSchedule(timesteps, beta_schedule, objective)
        self.auto_normalize = auto_normalize

    # -- value transforms ---------------------------------------------------
    def normalize(self, x):
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x):
        return (x + 1.0) * 0.5 if self.auto_normalize else x

    # -- conversions ---------------------------------------------------------
    def predict_start_from_noise(self, x_t, t, noise):
        s = self.sched
        return (_extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t -
                _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.sched
        return ((_extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
                / _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def predict_v(self, x_start, t, noise):
        s = self.sched
        return (_extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise -
                _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s = self.sched
        return (_extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t -
                _extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)

    def model_predictions(self, denoise_fn, x, t, condition,
                          clip_x_start=False):
        out = denoise_fn(x, t, condition)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (
            lambda v: v)
        if self.objective == "pred_noise":
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif self.objective == "pred_x0":
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:                                      # pred_v
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return pred_noise, x_start

    def q_posterior(self, x_start, x_t, t):
        s = self.sched
        mean = (_extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start +
                _extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        logvar = _extract(s.posterior_log_variance_clipped, t, x_t.ndim)
        return mean, logvar

    # -- training ------------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        s = self.sched
        return (_extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start +
                _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def p_losses(self, denoise_fn, x_start, t, noise, condition):
        x = self.q_sample(x_start, t, noise)
        out = denoise_fn(x, t, condition)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:                                      # pred_v
            target = self.predict_v(x_start, t, noise)
        loss = torch.mean((out - target) ** 2,
                          dim=tuple(range(1, out.ndim)))      # (B,)
        loss = loss * _extract(self.sched.loss_weight, t, 1)
        return torch.mean(loss)

    def loss(self, denoise_fn, x0, condition,
             generator: Optional[torch.Generator] = None, t=None,
             noise=None):
        """Training objective on data-space ``x0`` (conditionalDiffusion.py:
        781-798).  ``t`` (B,) and ``noise`` (x0's shape, in normalised
        space) are drawn from ``generator`` unless given (t first)."""
        B, dev = x0.shape[0], x0.device
        if t is None:
            t = torch.randint(0, self.num_timesteps, (B,), device=dev,
                              generator=generator)
        t = torch.as_tensor(t, device=dev).long()
        x0 = self.normalize(x0)
        if noise is None:
            noise = torch.randn(x0.shape, device=dev, dtype=x0.dtype,
                                generator=generator)
        noise = torch.as_tensor(noise, device=dev, dtype=x0.dtype)
        return self.p_losses(denoise_fn, x0, t, noise, condition)

    # -- sampling ------------------------------------------------------------
    def _x_start_coefs(self, time: np.ndarray) -> dict:
        """Per-step float32 coefficients of model_predictions()' linear
        conversions (the clip stays in the step)."""
        s = self.sched
        g = lambda a: np.asarray(a)[time]
        return {"srac": g(s.sqrt_recip_alphas_cumprod),
                "sracm1": g(s.sqrt_recipm1_alphas_cumprod),
                "sac": g(s.sqrt_alphas_cumprod),
                "somac": g(s.sqrt_one_minus_alphas_cumprod)}

    def _predictions_from_coefs(self, cf, img, out, clip_denoised):
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_denoised else (
            lambda v: v)
        if self.objective == "pred_noise":
            x_start = clip(cf["srac"] * img - cf["sracm1"] * out)
            pred_noise = out
        elif self.objective == "pred_x0":
            x_start = clip(out)
            pred_noise = (cf["srac"] * img - x_start) / cf["sracm1"]
        else:                                      # pred_v
            x_start = clip(cf["sac"] * img - cf["somac"] * out)
            pred_noise = (cf["srac"] * img - x_start) / cf["sracm1"]
        return pred_noise, x_start

    def _start(self, shape, like, generator, init_noise):
        if init_noise is None:
            return torch.randn(shape, generator=generator, **like)
        return torch.as_tensor(init_noise, **like).reshape(shape)

    def _step_tables(self, condition, table_fn, times: np.ndarray,
                     cf: Dict[str, torch.Tensor], step_noise,
                     device) -> Dict[str, torch.Tensor]:
        """Every per-step input of a sampler loop as a table with the step
        on its first axis: the time ``t``, the coefficients of ``cf``, the
        hoisted time tables of ``table_fn`` when it is given (``tab.*``)
        and the injected ``step_noise`` (``noise``)."""
        xs = {"t": torch.as_tensor(times, dtype=torch.long, device=device)}
        xs.update(cf)
        if table_fn is not None:
            tables = table_fn(torch.as_tensor(times, dtype=torch.float32,
                                              device=device))
            xs.update({f"tab.{k}": v for k, v in tables.items()})
        if step_noise is not None:
            xs["noise"] = torch.as_tensor(step_noise, device=device)
        return xs

    @staticmethod
    def _denoise(denoise_fn, img, x, condition):
        """The denoiser at the step whose row of the tables is ``x``."""
        t = x["t"].expand(img.shape[0])
        tables = {k[4:]: v for k, v in x.items() if k.startswith("tab.")}
        if not tables:
            return denoise_fn(img, t, condition)
        return denoise_fn(img, t, condition, tables)

    @staticmethod
    def _noise(x, shape, like, generator):
        """The step's noise: its injected row, else drawn."""
        if "noise" in x:
            return x["noise"].to(**like).reshape(shape)
        if _exporting():
            raise ValueError("an exported sampler takes its step noise "
                             "injected (step_noise)")
        return torch.randn(shape, generator=generator, **like)

    @staticmethod
    def _run_steps(body, img, xs: Dict[str, torch.Tensor]):
        """``img`` through ``body(img, x_i)`` for each step i, where x_i
        holds row i of every table of ``xs``.  Eagerly a Python loop;
        while ``torch.export`` traces, one ``scan`` over the rows, so an
        exported sampler holds one step's graph, as JAX's ``lax.scan``
        does, rather than a copy per step."""
        if _exporting():
            from torch._higher_order_ops import scan
            img, _ = scan(lambda c, x: (body(c, x), ()), img, xs)
            return img
        for i in range(xs["t"].shape[0]):
            img = body(img, {k: v[i] for k, v in xs.items()})
        return img

    @torch.no_grad()
    def ddim_sample(self, denoise_fn, shape, condition,
                    generator: Optional[torch.Generator] = None,
                    clip_denoised: bool = True, init_noise=None,
                    table_fn=None, step_noise=None):
        """DDIM over the static time pairs (conditionalDiffusion.py:
        674-709).  x_T is ``init_noise`` or drawn first; with eta != 0 each
        step then draws its noise, or takes ``step_noise[i]``."""
        like = _like(condition, generator, init_noise)
        device = like["device"]
        pairs = ddim_time_pairs(self.num_timesteps, self.sampling_timesteps)
        time, time_next = pairs[:, 0], pairs[:, 1]

        ac = np.asarray(self.sched.alphas_cumprod)            # float32
        alpha = ac[time]
        alpha_next = np.where(time_next < 0, np.float32(1.0),
                              ac[np.maximum(time_next, 0)])
        sigma = np.float32(self.eta) * np.sqrt(
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = np.sqrt(np.clip(1 - alpha_next - sigma ** 2, 0.0, None))
        sqan = np.sqrt(alpha_next)
        # final step (time_next < 0): img_next == x_start exactly
        last = time_next < 0
        sqan[last], c[last], sigma[last] = 1.0, 0.0, 0.0
        cf = _on(dict(self._x_start_coefs(time), sqan=sqan, c=c,
                      sigma=sigma), device)

        img = self._start(shape, like, generator, init_noise)
        xs = self._step_tables(condition, table_fn, time, cf, step_noise,
                               device)
        use_noise = self.eta != 0.0

        def step(img, x):
            out = self._denoise(denoise_fn, img, x, condition)
            pred_noise, x_start = self._predictions_from_coefs(
                x, img, out, clip_denoised)
            img_next = x_start * x["sqan"] + x["c"] * pred_noise
            if use_noise:
                img_next = img_next + x["sigma"] * self._noise(
                    x, shape, like, generator)
            return img_next

        return self.unnormalize(self._run_steps(step, img, xs))

    @torch.no_grad()
    def p_sample_loop(self, denoise_fn, shape, condition,
                      generator: Optional[torch.Generator] = None,
                      clip_denoised: bool = True, init_noise=None,
                      table_fn=None, step_noise=None):
        """Ancestral DDPM (conditionalDiffusion.py:643-672): x_T, then one
        noise draw a step (``step_noise[i]`` when given), the last one
        multiplied by 0."""
        like = _like(condition, generator, init_noise)
        device = like["device"]
        img = self._start(shape, like, generator, init_noise)
        ts = np.arange(self.num_timesteps - 1, -1, -1)
        s = self.sched
        std = np.exp(np.float32(0.5) * np.asarray(
            s.posterior_log_variance_clipped)[ts])
        std[ts == 0] = 0.0                         # final step: mean only
        cf = _on(dict(self._x_start_coefs(ts),
                      c1=np.asarray(s.posterior_mean_coef1)[ts],
                      c2=np.asarray(s.posterior_mean_coef2)[ts], std=std),
                 device)
        xs = self._step_tables(condition, table_fn, ts, cf, step_noise,
                               device)

        def step(img, x):
            out = self._denoise(denoise_fn, img, x, condition)
            _, x_start = self._predictions_from_coefs(x, img, out,
                                                      clip_denoised)
            mean = x["c1"] * x_start + x["c2"] * img
            return mean + x["std"] * self._noise(x, shape, like, generator)

        return self.unnormalize(self._run_steps(step, img, xs))

    def sample(self, denoise_fn, batch_size, condition,
               generator: Optional[torch.Generator] = None,
               clip_denoised: bool = True, init_noise=None, table_fn=None,
               step_noise=None):
        shape = (batch_size, self.seq_length, self.channels)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(denoise_fn, shape, condition, generator, clip_denoised,
                  init_noise, table_fn, step_noise)


def _exporting() -> bool:
    """Whether ``torch.export`` is tracing the caller."""
    return torch.compiler.is_exporting()


def _like(condition, generator, init_noise) -> dict:
    """The sample's device and dtype: the condition's device, else the
    injected x_T's or the generator's, else the host; the condition's
    dtype (float32 on every model path), else float32."""
    dtype = (condition.dtype if torch.is_tensor(condition)
             else torch.float32)
    device = next((t.device for t in (condition, init_noise)
                   if torch.is_tensor(t)),
                  generator.device if generator is not None else "cpu")
    return {"device": torch.device(device), "dtype": dtype}


class DiffusionJointEstimation(nn.Module):
    """Unet1D + GaussianDiffusion1D wired like reference
    diffusionJointEstimation.py:9-42 (dim 64, mults 1/2/4/8, channels 1,
    seq 63, T 400, DDIM 200).  ``sampler_hoist`` ('auto': when B <= 32;
    True or False to force) computes the time and condition MLPs and every
    block's time projection for all steps in one pass before the loop:
    the same products, batched over the steps."""

    def __init__(self, keypoint_num: int = 21, condition_feat_dim: int = 256,
                 num_timesteps: int = 400, num_sampling_timesteps: int = 200,
                 dim: int = 64, sampler_hoist="auto"):
        super().__init__()
        self.sampler_hoist = sampler_hoist
        self.unet = Unet1D(dim=dim, dim_mults=(1, 2, 4, 8), channels=1,
                           condition_feat_dim=condition_feat_dim)
        self.diffusion = GaussianDiffusion1D(
            seq_length=keypoint_num * 3, channels=1, timesteps=num_timesteps,
            sampling_timesteps=num_sampling_timesteps)

    def forward(self, x0, condition, generator=None, t=None, noise=None):
        """Training loss; ``x0`` (B, 1, 63) like the reference pose_x0;
        ``t`` (B,) and ``noise`` (B, 1, 63, normalised space) optionally
        inject the loss's draws."""
        x0 = x0.transpose(1, 2)                    # (B, 63, 1)
        if noise is not None:
            noise = torch.as_tensor(noise, device=x0.device).transpose(1, 2)
        return self.diffusion.loss(self.unet, x0, condition, generator,
                                   t=t, noise=noise)

    def hoists(self, batch_size: int) -> bool:
        if self.sampler_hoist == "auto":
            return batch_size <= 32
        return bool(self.sampler_hoist)

    def sample(self, condition, generator=None, init_noise=None,
               step_noise=None):
        """(B, 1, 63) sample in data space.  ``init_noise``: an optional
        (B, 1, 63) x_T in the reference's layout (with DDIM eta 0 the
        sample is then deterministic); ``step_noise``: optional (S, B, 1,
        63) per-step noise (DDPM, or DDIM with eta != 0)."""
        B, dev = condition.shape[0], condition.device
        if init_noise is not None:
            init_noise = torch.as_tensor(init_noise, device=dev).transpose(
                1, 2)
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, device=dev).transpose(
                2, 3)
        if self.hoists(B):
            table_fn = lambda times: self.unet(None, times, condition)
            denoise = lambda x, t, c, tab: self.unet(x, t, c,
                                                     time_tables=tab)
        else:
            table_fn, denoise = None, self.unet
        out = self.diffusion.sample(denoise, B, condition, generator,
                                    init_noise=init_noise, table_fn=table_fn,
                                    step_noise=step_noise)
        return out.transpose(1, 2)                 # (B, 1, 63)
