"""The benchmark of the port (``repro_torch``): ``build_nng`` graphs on one
H100. ``run.py`` runs one cell of ``BENCHMARK.json``; see ``README.md``."""
