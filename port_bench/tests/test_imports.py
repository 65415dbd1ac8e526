"""The import check compares whole top-level names, and neither the
benchmark nor its reference loads what it may not."""

import subprocess
import sys

import pytest

from port_bench.manifest import ROOT
from port_bench.run import forbidden_modules


@pytest.mark.parametrize("names,found", [
    (["handpose_tpu_torch", "handpose_tpu_torch.ops"], []),
    (["handpose_tpu.config"], ["handpose_tpu"]),
    (["handpose_tpu"], ["handpose_tpu"]),
    (["jax.numpy", "torch"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "handpose_tpu_x"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_the_harness_and_the_port_load_no_jax():
    tops = _loaded_after(
        "import port_bench.run, port_bench.control, port_bench.calibrate\n"
        "import port_bench.drivers.train, port_bench.drivers.serve\n"
        "import handpose_tpu_torch.train, handpose_tpu_torch.infer.serving")
    assert not tops & {"jax", "jaxlib", "flax", "handpose_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    tops = _loaded_after(
        "import port_bench.reference.trainer_b, port_bench.reference.train\n"
        "import port_bench.reference.synth, port_bench.counts\n"
        "import port_bench.weights, port_bench.correct")
    assert not tops & {"handpose_tpu_torch", "handpose_tpu", "jax"}
