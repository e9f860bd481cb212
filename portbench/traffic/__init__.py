"""Traffic mixes: ``<name>.json`` parameter files read by ``content.py``."""
