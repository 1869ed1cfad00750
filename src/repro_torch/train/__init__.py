"""Training-side pieces of the port (so far the checkpoint reader)."""
