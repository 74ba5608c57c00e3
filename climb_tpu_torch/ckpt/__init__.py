"""The weight bridge to climb_tpu and reference checkpoints, and task checkpoints."""
