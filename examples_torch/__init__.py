"""The reference's examples (``examples/``), ported to ``repro_torch``.

Each module is a ``main(argv=None)`` that runs on ``cuda`` unless given
``--device cpu`` and makes the reference example's own assertions.  On the
card attention runs through the hand-written kernels (``attn_impl``
``flash``), on the CPU as the config says:

    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
