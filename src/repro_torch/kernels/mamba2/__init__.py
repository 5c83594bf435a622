"""The chunked Mamba-2 SSD scan kernel (see ``ops.mamba2_ssd``)."""
from .ops import mamba2_ssd  # noqa: F401
