"""Frechet distance (FID) evaluation for the image-diffusion demo.

Port of ``handpose_tpu/utils/fid.py`` (the reference scratchpad's
Keras-InceptionV3 FID, example/diffusionExample.py:293-370): two sample
sets -> feature activations -> Frechet distance between their Gaussian
fits

    FID = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 @ S2)).

The Frechet math is the reference's exactly (numpy and scipy, with the
real-part correction for numerical imaginary components).  The feature
extractor is pluggable.  The reference uses ImageNet-pretrained
InceptionV3 (``include_top=False, pooling='avg'``), whose weights are not
in the repository.  The default here is a FIXED, seeded
random-convolution network with global average pooling: a PROXY.
Random-feature Frechet distances keep the metric's structure (0 for
identical distributions, monotone in distributional distance) and are
reproducible across runs, but the absolute numbers are NOT comparable to
InceptionV3 FID scores, nor to the JAX package's proxy from the same
seed (the kernels come from another generator).  When a genuine feature
extractor is available, pass it as ``features``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def frechet_distance(act1: np.ndarray, act2: np.ndarray) -> float:
    """Frechet distance between Gaussian fits of two (N, D) activation
    sets (reference diffusionExample.py:307-323: numpy mean and cov,
    scipy sqrtm, real part)."""
    from scipy.linalg import sqrtm

    act1 = np.asarray(act1, np.float64)
    act2 = np.asarray(act2, np.float64)
    mu1, sigma1 = act1.mean(axis=0), np.cov(act1, rowvar=False)
    mu2, sigma2 = act2.mean(axis=0), np.cov(act2, rowvar=False)
    ssdiff = float(np.sum((mu1 - mu2) ** 2.0))
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(ssdiff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def _same_pad(x: torch.Tensor, stride: int, k: int = 3) -> torch.Tensor:
    """XLA's 'SAME' padding of (N, C, H, W) for a k x k window: the
    total, split low = total // 2, high = the rest."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def random_conv_kernels(in_channels: int, feature_dim: int = 64,
                        seed: int = 0) -> list:
    """The proxy's three (3, 3, in, out) HWIO kernels, He-scaled normal
    draws from a generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    kernels, c_in = [], in_channels
    for w in (32, 64, feature_dim):
        kernels.append(torch.randn((3, 3, c_in, w), generator=gen)
                       * math.sqrt(2.0 / (9 * c_in)))
        c_in = w
    return kernels


def random_conv_features(images: np.ndarray, feature_dim: int = 64,
                         seed: int = 0,
                         kernels: Optional[Sequence] = None) -> np.ndarray:
    """Fixed random 3-layer conv net (3x3, 'SAME', stride 1 then 2 and 2,
    ReLU) + global average pool: the InceptionV3 proxy.  ``images`` (N,
    H, W, C) floats in any consistent range, a numpy array (computed on
    the host) or a tensor (computed on its device); ``kernels`` (three
    HWIO arrays) default to :func:`random_conv_kernels`.  Returns (N,
    feature_dim) float32 activations."""
    x = torch.as_tensor(images, dtype=torch.float32).permute(0, 3, 1, 2)
    if kernels is None:
        kernels = random_conv_kernels(x.shape[1], feature_dim, seed)
    for i, k in enumerate(kernels):
        stride = 2 if i > 0 else 1
        w = torch.as_tensor(k, dtype=torch.float32,
                            device=x.device).permute(3, 2, 0, 1)
        x = F.relu(F.conv2d(_same_pad(x, stride), w, stride=stride))
    return x.mean(dim=(2, 3)).cpu().numpy()


def fid_score(images1: np.ndarray, images2: np.ndarray,
              features=None) -> float:
    """FID between two image sets.  ``features``: (N, H, W, C) -> (N, D)
    extractor; defaults to the seeded random-conv proxy."""
    features = features or random_conv_features
    return frechet_distance(features(images1), features(images2))
