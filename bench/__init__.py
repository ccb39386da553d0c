"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration
(``configs/<name>.json``), its traffic (``traffic/<name>.json``, read by
``drivers/<driver>.py``), its data (``data/<generator>.py``), the system
under test (``systems/<system>.py``) and its per-layer metrics
(``metrics/<metric>.py``).  ``reference/`` is the plain version the answers
are judged against; it imports nothing of the program.
"""
