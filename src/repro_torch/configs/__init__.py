"""Architecture configs of the port (the fields its models read)."""
