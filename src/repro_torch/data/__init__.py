"""The port's data pipeline (``repro.data`` is the reference)."""
