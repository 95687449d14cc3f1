"""The benchmark of ``stellar_core_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line last.  Every piece is found by name: a cell's traffic in
``workloads/<cell>.json``, its deployment in ``configs/<config>.json``, the
way it drives the program in ``drivers/<driver>.py`` and each metric's
reader in ``metrics/<metric>.py``.
"""
