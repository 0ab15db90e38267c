"""regbench: the benchmark of ``teaserpp_tpu_torch`` on an NVIDIA GPU.

One command runs one cell once and prints one JSON line::

    python3 -m regbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell is ``workloads/<cell>.json``, which
names its configuration ``configs/<config>.json`` (the deployment: problem
sizes, the generator ``generators/<name>.py`` and the solver's
parameters) and its traffic mix ``traffic/<traffic>.json`` (its driver
``traffic/<driver>.py``, the entry point ``entries/<entry>.py`` it calls
and the driver's parameters). End-to-end metrics are
``end_to_end/<name>.py`` and per-layer metrics ``metrics/<name>.py``, a
name's reader found by its part before the first dot where it has no file
of its own; ``BENCHMARK.json`` at the root of the checkout says which a
cell reports. A new cell, configuration, traffic mix, driver or metric is
new files and new ``BENCHMARK.json`` entries.

The yardstick lives here: the problem generators, the plain reference
(``reference/``) and the comparison that decides ``correct``
(``checks.py``), the reduction of the profiler's trace (``trace.py``) and
the table of peaks with K1's operation count (``yardstick.py``). Nothing
here imports JAX or the JAX package, and the reference imports nothing of
the program.
"""
