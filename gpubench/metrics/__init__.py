"""Per-layer metrics, one reader per file: ``read(ctx)`` returns the
metric's value, or None where the run holds nothing to read it from
(a metric of a share is never 0 for want of a reading)."""
