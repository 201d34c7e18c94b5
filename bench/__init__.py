"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/`` (which names its program adapter in ``programs/``, its
reference in ``reference/`` and its counts in ``work/``), its traffic mix
in ``traffic/`` (which names its window driver in ``drivers/`` and its
graph generator in ``graphs/``), each metric's reader in ``metrics/`` and
its correctness limits in ``limits/``.  ``reference/`` (plain PyTorch) and
``work/`` (operation and byte counts, the table of peaks) import nothing
of the program.  See ``README.md``.
"""
