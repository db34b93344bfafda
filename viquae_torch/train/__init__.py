"""Training: trainer, trainees, objectives, optimizer, collators,
checkpoints, the config-driven entry point and the QA metrics."""
