"""Training: the train and eval steps, AdamW, the train state, the task trainer and
model construction."""
