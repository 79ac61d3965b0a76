"""The port's benchmark: the harness, its drivers, readers, reference and
tests (see ``run.py``)."""
