"""PyTorch/CUDA port of the ThemisIO reproduction (the JAX package ``repro``
is the reference).

This slice runs the performance engine's tick loop for the ``themis`` and
``fifo`` schedulers, with the worker phase on two hand-written CUDA kernels
(``kernels/tick_step`` and ``kernels/token_select``).  Entry points:

    repro_torch.api.Experiment(..., device="cuda").add_job(...).run(seconds)
    repro_torch.core.engine.run(cfg, wl, table, seconds)

Both run on the card unless the caller asks for ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.  Importing this package is
cheap: it loads no submodule, builds no kernel and imports neither ``jax``
nor anything of ``repro``.
"""
from __future__ import annotations

import importlib

__all__ = ["api", "core", "kernels", "scenario", "resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ._device import resolve_device
        return resolve_device
    if name in ("api", "core", "kernels", "scenario"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
