"""The per-layer metric readers, one file each, found by name (``spec.metric_reader``)."""
