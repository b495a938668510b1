"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``bench/configs/<config>.json``, the architecture module that
configuration names in ``bench/archs/<arch>.py`` (``decoder`` where it
names none), its traffic in ``bench/traffic/<mix>.json`` and each
metric's reader in ``bench/metrics/<metric>.py``.
"""
