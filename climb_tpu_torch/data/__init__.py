"""Synthetic data, collation and the eval loader."""
