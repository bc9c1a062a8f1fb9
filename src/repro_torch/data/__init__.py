"""Synthetic datasets (a copy of ``repro.data.synthetic``)."""
