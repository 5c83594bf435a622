"""The statistical-token draw kernel (see ``ops.token_select``)."""
from .ops import token_select  # noqa: F401
