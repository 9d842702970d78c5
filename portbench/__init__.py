"""The benchmark of the PyTorch port (``eegnetreplication_tpu_torch``).

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 -m portbench.run --workload eegnet.cross90 --seed 7 \
        --seconds 20 --trace 0

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<workload>.json``.  The plain
reference that decides ``correct`` is ``reference/``; it imports nothing
of the port.
"""
