"""The benchmark of ``handpose_tpu_torch`` on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix, both
named in ``BENCHMARK.json`` at the repository root) once:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The yardstick lives here and nowhere in the measured package: the
inputs and weights made from the seed, the plain reference
(``reference/``), the operation and byte counts (``counts.py``), the
reading of the profiler's trace (``trace.py``) and the comparison that
decides ``correct`` (``correct.py``).  Nothing here imports JAX or the
JAX package.
"""
