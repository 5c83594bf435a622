"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``token_select`` and ``tick_step`` (sources in ``csrc/``, built by
``_build``)."""
