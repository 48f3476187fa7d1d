"""portbench: the benchmark of ``ppca_rs_tpu_torch`` on one CUDA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, per-layer metric, kind of
step or cell sits in a file of its own that :mod:`portbench.spec` finds by
name.  Nothing here imports JAX or the JAX package, and
``portbench/reference`` imports nothing of ``ppca_rs_tpu_torch``.
"""
