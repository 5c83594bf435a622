"""The LLM substrate of the port: layers, attention, the Mamba-2 and
RWKV-6 blocks and the decoder (``repro.models`` is the reference)."""
