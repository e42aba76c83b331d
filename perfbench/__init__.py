"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

Driven by ``BENCHMARK.json`` at the root of the checkout: each cell there
names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and its job (``workloads/<cell>.json``); each
per-layer metric has its reader in ``metrics/<name>.py``.  Run from the
root of a checkout::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Nothing here imports ``jax`` or the JAX package; the plain references in
``reference/`` import nothing of the port either.
"""
