"""Training of the port: AdamW with its schedules (``optimizer``) and the
train step (``train_step``), mirroring ``repro.train``."""
