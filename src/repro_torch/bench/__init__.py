"""The paper's figure rows on the port: Fig. 8 (``policies``) and Fig. 12
(``comparison``), with the row names, job lists, windows and seeds of the
reference's ``benchmarks/bench_policies.py`` and ``bench_comparison.py``.
``fig_reference.json`` holds the reference's numbers for the same rows
(``tools/record_figure_reference.py`` writes it)."""
