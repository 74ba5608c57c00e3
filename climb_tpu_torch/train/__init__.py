"""The serving forward and model construction."""
