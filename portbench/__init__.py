"""The benchmark of ``thermalporous_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout: it builds the cell's configuration on the card from the seed,
runs the cell's set-up, measures a window of whole controller episodes
through ``Simulator.run``, judges the states the window produced against
the plain reference in ``portbench/reference/``, and prints one JSON line.

Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``), correctness limits (``limits/<cell>.json``),
field recipes (``fields/<recipe>.py``) and per-layer metric readers
(``metrics/<metric>.py``) are found by name, so a new cell, configuration
or metric is a new file and a new entry in ``BENCHMARK.json``.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``thermalporous_tpu``.
"""
