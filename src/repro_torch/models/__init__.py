"""The LLM substrate of the port: layers, attention and the dense decoder
(``repro.models`` is the reference)."""
