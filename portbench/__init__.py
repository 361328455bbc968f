"""The benchmark of ``flechasdb_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: the
configuration in ``configs/``, the traffic mix in ``mixes/`` (which names
its driver in ``drivers/``), each metric's reader in ``metrics/``, the
kernels' work in ``roofline/`` and the limits of the correctness check in
``limits/``. The plain reference that decides ``correct`` is in
``reference/``; it imports nothing of the program.
"""
