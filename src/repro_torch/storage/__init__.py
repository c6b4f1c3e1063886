"""Storage for training: a volume on a local directory (``volume``), the
token data pipeline (``datapipe``) and sharded, crash-safe checkpoints
(``checkpoint``), mirroring ``repro.storage`` without the CFS cluster."""
