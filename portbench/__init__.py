"""The benchmark of the PyTorch/CUDA port of FAVOR (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: it makes the cell's
data on the card from the seed, builds the HNSW graph there, hands both to
the port, drives the port's batch search for the window, checks a sample
of the answers against a plain reference, and prints one JSON line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
