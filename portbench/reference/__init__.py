"""Plain references of the benchmark's configurations: ``<config>.py``
holds ``reference(batch, config, precision)``, built on ``plain.py``."""
