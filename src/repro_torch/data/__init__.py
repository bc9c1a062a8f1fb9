"""Synthetic datasets and the LM token loader (copies of ``repro.data.synthetic``
and ``repro.data.sharded_loader``)."""
