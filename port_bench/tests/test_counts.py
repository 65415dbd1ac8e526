"""The FLOP and byte counts against counts made by hand at the cells'
shapes, and the FLOPs against torch's own counter on the reference."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts, weights
from port_bench.manifest import HERE
from port_bench.reference import preprocess, synth, trainer_b

B = 256
# ResNet-18, 256 x 256, convolution multiply-adds by stage (the stem for
# 21 input channels: 128^2 * 64 * 21 * 9), plus the 512 x 1000 fc
R18 = {"stem21": 198_180_864, "stem3": 28_311_552,
       "stage1": 603_979_776, "stage2": 536_870_912,
       "stage3": 536_870_912, "stage4": 536_870_912, "fc": 512_000}
# ResNet-50, 256 x 256 (bottlenecks, projections at each stage's first)
R50 = {"stage1": 872_415_232, "stage2": 1_342_177_280,
       "stage3": 1_912_602_624, "stage4": 1_056_964_608, "fc": 2_048_000}
# (rows, channels, launches a trunk) of every BatchNorm at b256, crop 256
BN18 = ((B * 128 * 128, 64, 1), (B * 64 * 64, 64, 4), (B * 32 * 32, 128, 5),
        (B * 16 * 16, 256, 5), (B * 8 * 8, 512, 5))
BN50 = ((B * 128 * 128, 64, 1), (B * 64 * 64, 64, 6), (B * 64 * 64, 256, 4),
        (B * 64 * 64, 128, 1), (B * 32 * 32, 128, 7), (B * 32 * 32, 512, 5),
        (B * 32 * 32, 256, 1), (B * 16 * 16, 256, 11),
        (B * 16 * 16, 1024, 7), (B * 16 * 16, 512, 1), (B * 8 * 8, 512, 5),
        (B * 8 * 8, 2048, 4))


def config(name):
    return json.load(open(HERE / "configs" / f"{name}.json"))


@pytest.mark.parametrize("channels", [21, 3])
def test_resnet18_macs(channels):
    stem = R18[f"stem{channels}"]
    want = stem + sum(v for k, v in R18.items() if not k.startswith("stem"))
    assert counts.trunk_macs(18, channels, 256) == want


def test_resnet50_macs():
    assert counts.trunk_macs(50, 3, 256) == R18["stem3"] + sum(R50.values())


def test_trunks_found_in_the_leaves():
    assert counts.trunks(trainer_b.spec(config("posepriornet"))) == [
        (18, 21, 3), (18, 21, 3)]
    assert counts.trunks(trainer_b.spec(config("hand3dposenet-r50"))) == [
        (50, 3, 3)]


def test_forward_flops_of_the_configurations():
    pp = config("posepriornet")
    # two trunks; the heads' products: 1000-500-250-125-63, 1000-250-62-15-3-3
    heads = 664_125 + 266_484
    assert counts.forward_flops(256, trainer_b.spec(pp)) == 2 * (
        2 * counts.trunk_macs(18, 21, 256) + heads)
    r50 = config("hand3dposenet-r50")
    # fc_proj 1000x1024; 1024-256-64-63; 1024-256-64-64; 3 x 64-1
    dense = 1_024_000 + 282_560 + 282_624 + 192
    flops = counts.forward_flops(256, trainer_b.spec(r50))
    assert flops == 2 * (counts.trunk_macs(50, 3, 256) + dense)
    assert flops == 10_432_217_344


@pytest.mark.parametrize("name", ["posepriornet", "hand3dposenet-r50"])
def test_flops_equal_torch_counter_on_the_reference(name):
    cfg = {**config(name), "crop": 64}
    spec = trainer_b.spec(cfg)
    w = weights.make(spec, torch.Generator().manual_seed(0))
    raw = synth.raw_fields(synth.make_samples(2, torch.Generator()
                                              .manual_seed(1)))
    pp = preprocess.preprocess(raw, 64, 25.0)
    with FlopCounterMode(display=False) as fc:
        trainer_b.forward(w, pp, cfg, False)
    assert fc.get_total_flops() == 2 * counts.forward_flops(64, spec)


def test_kernel_bytes_at_the_held_shapes():
    assert counts.k1_bytes(B, 21, 256) == 1_409_334_528
    pp = trainer_b.spec(config("posepriornet"))
    r50 = trainer_b.spec(config("hand3dposenet-r50"))
    assert counts.k2_bytes(256, pp, B) == 2 * sum(
        n * (N * C * 2 + 3 * C * 4) for N, C, n in BN18)
    assert counts.k2_bytes(256, r50, B) == sum(
        n * (N * C * 2 + 3 * C * 4) for N, C, n in BN50)
    assert counts.k3_bytes(256, pp, B) == 2 * 1_207_959_552
    assert counts.k3_bytes(256, r50, B) == 1_207_959_552


def test_roofline_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0, 1e12) == pytest.approx(1.0)
    assert counts.least_seconds(0, 2e12, 1e12) == pytest.approx(2.0)
