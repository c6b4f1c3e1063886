"""One reader a metric, in a file named after it: ``read(record, ctx)`` gives
the metric's value from the run's record (host clock times, counters) and
the device trace's summary (``ctx.trace``), or None where the run holds
nothing to read, and the metric is then left out of the result."""
