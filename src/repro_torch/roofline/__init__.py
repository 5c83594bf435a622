"""Analytic rooflines of the port's kernels (the reference's
``repro.roofline``, so far its :func:`~.analysis.tick_step_roofline`)."""
