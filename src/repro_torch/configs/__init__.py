"""Model configurations of the port (its own copy of ``repro.configs``)."""
