"""Storage for training: the token data pipeline (``datapipe``) and sharded,
crash-safe checkpoints (``checkpoint``), mirroring ``repro.storage``, on a
volume of the port's CFS (``core.fs.CfsMount``) or on a local directory
(``volume.LocalMount``)."""
