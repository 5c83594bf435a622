"""The reference's benchmark rows on the port: Fig. 8 (``policies``) and
Fig. 12 (``comparison``), the scenario rows (``scenarios``) and the batch
plane's rows (``batch``), with the row names, job lists, windows and seeds
of the reference's ``benchmarks/bench_policies.py``,
``bench_comparison.py``, ``bench_scenarios.py`` and ``bench_batch.py``.
``fig_reference.json``, ``scen_reference.json`` and
``batch_reference.json`` hold the reference's numbers for the same rows
(``tools/record_figure_reference.py`` writes them)."""
