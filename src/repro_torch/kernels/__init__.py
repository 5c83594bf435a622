"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``token_select``, ``tick_step`` and ``flash_attention`` (sources in
``csrc/``, built by ``_build``)."""
