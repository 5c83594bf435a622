"""PyTorch/CUDA port of the ThemisIO reproduction (the JAX package ``repro``
is the reference).

It runs the performance engine's tick loop for the reference's six
schedulers (themis and fifo with the worker phase on the hand-written
``kernels/tick_step`` kernel, themis's per-worker draw on
``kernels/token_select``), seed and parameter batches as lanes of one loop,
the paper's Fig. 8 and Fig. 12 rows and the scenario rows (``bench``),
phased scenarios as combinator trees and JSON (``scenario``), the
burst-buffer service (``bb`` over the ``fs`` file system, its themis pops on
``kernels/token_select``), and LM serving for
the dense, Mamba-2 hybrid and RWKV-6 architectures on the
``flash_attention``, ``mamba2_ssd`` and ``wkv6`` kernels.  Entry points:

    repro_torch.api.Experiment(..., device="cuda").add_job(...).run(seconds)
    repro_torch.core.engine.run(cfg, wl, table, seconds) / run_batch(...)
    repro_torch.bench.policies.run_fig8 / repro_torch.bench.comparison.run_fig12
    repro_torch.bench.scenarios.run_scen
    repro_torch.api.Experiment.from_scenario(preset(name), ...).serve().replay(...)
    repro_torch.serve.serve_step.make_prefill_step / make_decode_step
    repro_torch.serve.engine.ServeEngine, python -m repro_torch.launch.serve

Both run on the card unless the caller asks for ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.  Importing this package is
cheap: it loads no submodule, builds no kernel and imports neither ``jax``
nor anything of ``repro``.
"""
from __future__ import annotations

import importlib

_SUBPACKAGES = ("api", "bb", "bench", "core", "fs", "kernels", "scenario")
__all__ = [*_SUBPACKAGES, "resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ._device import resolve_device
        return resolve_device
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
