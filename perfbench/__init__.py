"""The benchmark of ``africanus_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see ``perfbench/run.py``). Every
configuration, cell, entry, metric and work count is a
file of its own under this folder, found by the name ``BENCHMARK.json``
gives it; the plain references are under ``reference/`` and import
nothing of the program.
"""
