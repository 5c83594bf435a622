"""Serving: the prefill/decode steps and the multi-tenant ``ServeEngine``
(``repro.serve`` is the reference)."""
