"""The benchmark of ``repro_torch`` (see README.md)."""
