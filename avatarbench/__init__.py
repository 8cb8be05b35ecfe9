"""The benchmark of ``instantavatar_torch`` on one NVIDIA GPU.

``python3 -m avatarbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/``, its limits in ``limits/``,
each metric's reader in ``metrics/``, each configuration's plain
reference in ``reference/``.
"""
