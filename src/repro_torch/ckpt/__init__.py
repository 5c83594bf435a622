"""The port's checkpoints (``repro.ckpt`` is the reference)."""
