"""One reader a metric: ``portbench/metrics/<metric>.py`` holds
``read(rec) -> float | None``, the metric's value from one run's records,
or None where the run has nothing for it to read (the harness then leaves
the metric out of the result line).

``rec`` holds: ``cfg`` (the configuration file), ``traffic``, ``setup_s``,
``steps`` (the window's steps: ``bucket``, ``batch``, ``seq``, ``wall_s``
around ``Trainer.train(1)``, the trainer's ``time_s`` and ``grad_s``,
``stage``, and ``exec``, the executor's counters (``Execution.last``),
where the step ran a policy), ``window_s``, ``peak_bytes``, ``runtime``
(Chameleon's ``rt.stats()`` just before and just after the window, or
None with Chameleon off) and ``trace`` (``portbench.devtrace.read`` of
the traced steps, with
their ``steps``; None without ``--trace 1``).
"""
