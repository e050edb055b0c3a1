"""Training: AdamW, the synthetic data pipeline, checkpoints, gradient
compression and the resumable train loop (the port of
``repro/training``; ``elastic`` waits for the distribution work, ROADMAP
open item 10)."""
