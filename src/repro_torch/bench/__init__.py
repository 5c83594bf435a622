"""The reference's benchmark rows on the port, section by section: Fig. 7
(``scaling``), Fig. 8 (``policies``), Figs. 9-11 (``composite``), Fig. 12
(``comparison``), Fig. 13 (``apps``), Fig. 14 (``lambda_sync``), the
scenario rows (``scenarios``), the batch plane's rows (``batch``), the
fleet rows (``fleet``), the kern ladder (``tick``) and the micro rows
(``kernels``), with the row names, job lists, windows and seeds of the
reference's ``benchmarks/``.  ``run`` is the harness (``python -m
repro_torch.bench.run``), ``trend`` the perf trend and its gate,
``calibrate`` the AdapTBF / plan calibration.  ``*_reference.json`` hold
the reference's numbers for the same rows
(``tools/record_figure_reference.py`` writes them)."""
