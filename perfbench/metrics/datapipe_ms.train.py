"""datapipe_ms.train: host milliseconds a step inside ShardReader.batch_at (the
trainer's batch read through the CFS client's hedged reads), the mean over
the window's steps."""


def read(record, ctx):
    s = record.get("batch_s") or []
    return 1e3 * sum(s) / len(s) if s else None
