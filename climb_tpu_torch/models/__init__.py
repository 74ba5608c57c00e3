"""The ViLT model family."""
