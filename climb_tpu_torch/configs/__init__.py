"""Task registry."""
