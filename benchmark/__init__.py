"""The benchmark of ``rsoccer_tpu_torch`` on an NVIDIA card: ``run.py`` runs one
cell of ``BENCHMARK.json`` once and prints one JSON line."""
