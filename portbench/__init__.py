"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints one
JSON line. What belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by its name: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py`` and ``limits/<cell>.json``.
The yardstick (traffic, weights, work counts, trace reduction, the plain
reference and the comparison that decides ``correct``) lives here; the
program under test is imported only by ``serving.py`` and ``harness.py``.
"""
