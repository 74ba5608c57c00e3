"""Weight bridge from climb_tpu and reference checkpoints."""
