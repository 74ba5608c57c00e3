"""Continual-learning algorithms (counterpart of ``climb_tpu/cl``)."""
