"""Training: AdamW with the reference's schedule, the train step and loop,
checkpoints in the reference's format."""
