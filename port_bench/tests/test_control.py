"""The control fails the comparison at each cell's own size, on the card.

``python3 -m pytest -m gpu port_bench/tests/test_control.py`` on a
machine with a CUDA card: for every cell, the reference computed in the
precision below the configuration's (``control.py``) in the measured
package's place, and for training cells the planted half-batch fault,
each read on one seed and judged by the cell's own limits.  The CPU
sizes of ``test_run.py`` cannot stand in: the limits are set for the
cells' sizes."""

import pytest
import torch

from port_bench import control, correct
from port_bench.manifest import Manifest

M = Manifest.load()
CASES = [(cell, which) for cell, w in M.cells.items()
         for which in control.KINDS[M.traffic(w["traffic"])["kind"]]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,which", CASES)
def test_control_is_not_correct(cell, which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    w = M.cell(cell)
    kind = M.traffic(w["traffic"])["kind"]
    numbers, _ = control.readings(cell, 2 ** 31 + 11, "cuda", which)
    ok, checks = correct.judge(numbers, M.config(w["config"])["limits"][kind])
    assert not ok, checks
