"""Transfer and forgetting scores of a continual-learning run."""
