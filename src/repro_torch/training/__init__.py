"""Training: AdamW, the synthetic data pipeline, checkpoints, gradient
compression, the resumable train loop and elastic remeshing (the port of
``repro/training``)."""
