"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``token_select``, ``tick_step``, ``flash_attention``, ``mamba2``
(the SSD scan) and ``rwkv6`` (the WKV recurrence); sources in ``csrc/``,
built by ``_build``."""
