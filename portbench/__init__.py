"""The benchmark of the PyTorch and CUDA port (``imageenhancement_mp_tpu_torch``),
driven by ``BENCHMARK.json`` at the repository's root: ``run.py`` runs one cell."""
