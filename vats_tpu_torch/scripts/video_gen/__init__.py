"""The port's entry-point scripts (run with ``python -m``)."""
