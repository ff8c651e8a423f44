"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json`` once (``python3 -m portbench.run``).

A cell's configuration, traffic mix and limits, and each metric's reader,
are files of their own under this package, found by the names in
``BENCHMARK.json`` (``portbench.harness``).  Nothing here imports JAX or
the JAX package; ``portbench.reference`` imports nothing of the port.
"""
