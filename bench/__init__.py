"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric, check limit or reference routine is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: sizes, dtype, source (``file`` in the spec);
- ``traffic/<mix>.json``: the public calls of a request, the LAPACK
  driver it stands for, the parameters of its items, the right-hand
  sides;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``reference/<routine>.py``: one driver's plain reference, its LAWN 41
  count and its kind of item;
- ``metrics/<metric>.py``: the reader of one metric.

The yardstick (the LAWN 41 counts, the peaks and bounds, the trace
reader) lives here too, so that a change to the port cannot move it.
Nothing here imports JAX or the JAX package.
"""
