"""One reader per metric: ``<name>.py`` holds ``read(record)``, which takes
a run's record (``harness.run_cell``) and returns the metric's value, or
None where the record holds nothing for it to read."""
