"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader gets the run's context: ``kind`` ('train' or 'serve'),
``config``, ``traffic``, ``trace`` (a :class:`port_bench.trace.Trace` of
the traced window), ``split`` (the layers' CUDA-event times), the steps
or calls in the traced window, the untraced rate (``images_per_s``),
and the host timers the driver read.  It returns a number, or None
when the run gave it nothing to read.
"""

from __future__ import annotations

from . import counts, reference


def split(ctx: dict, key: str):
    return ctx.get("split", {}).get(key)


def units(ctx: dict) -> int:
    """The steps (train) or calls (serve) of the traced window."""
    return ctx["steps_traced"] if ctx["kind"] == "train" \
        else ctx["calls_traced"]


def roofline(ctx: dict, patterns, n_bytes: int, flops: int,
             flops_peak: float = counts.F32_FLOPS):
    """100 x the least time of the work one step or call needs of a
    kernel (``n_bytes`` and ``flops``), times the traced window's steps
    or calls, over the kernel's summed device time there; None when the
    window ran no such kernel."""
    seconds, launches = ctx["trace"].kernel_seconds(patterns)
    if not launches or seconds <= 0:
        return None
    least = counts.least_seconds(n_bytes, flops, flops_peak) * units(ctx)
    return 100.0 * least / seconds


def mfu(ctx: dict) -> float:
    """100 x the network's FLOPs at the untraced rate over the card's
    dense bfloat16 peak; a trained image counts three forwards."""
    cfg = ctx["config"]
    per_image = counts.forward_flops(cfg["crop"], _spec(ctx))
    if ctx["kind"] == "train":
        per_image *= counts.TRAIN_FORWARDS
    return 100.0 * per_image * ctx["images_per_s"] / counts.BF16_FLOPS


def idle_pct(ctx: dict) -> float:
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


K1 = ("scoremap_",)
K2 = ("moments_partial_kernel", "moments_final_kernel")
K3 = ("pool_bwd",)


def k1(ctx: dict):
    B, side = ctx["traffic"]["batch"], ctx["config"]["crop"]
    return roofline(ctx, K1, counts.k1_bytes(B, 21, side),
                    counts.k1_flops(B, 21, side))


def k2(ctx: dict):
    side, spec, B = ctx["config"]["crop"], _spec(ctx), ctx["traffic"]["batch"]
    return roofline(ctx, K2, counts.k2_bytes(side, spec, B),
                    counts.k2_flops(side, spec, B))


def k3(ctx: dict):
    side, spec, B = ctx["config"]["crop"], _spec(ctx), ctx["traffic"]["batch"]
    return roofline(ctx, K3, counts.k3_bytes(side, spec, B),
                    counts.k3_flops(side, spec, B))


def _spec(ctx: dict):
    return reference.module(ctx["config"]).spec(ctx["config"])
