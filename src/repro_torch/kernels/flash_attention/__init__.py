"""The flash-attention forward kernel (see ``ops.flash_attention``)."""
from .ops import flash_attention  # noqa: F401
