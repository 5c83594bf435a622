"""The fused per-tick worker-phase kernel (see ``ops.tick_step``)."""
from .ops import MODES, tick_step  # noqa: F401
