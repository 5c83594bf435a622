"""The chunked RWKV-6 WKV recurrence kernel (see ``ops.wkv6``)."""
from .ops import wkv6  # noqa: F401
