"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card and prints
one JSON line.  Every piece is found by name: a cell's configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (read by
the driver ``drivers/<kind>.py`` the mix names), its output check's limits in
``checks/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, and each family's plain reference in
``reference/<family>.py``.  Nothing here imports JAX or the JAX package.
"""
