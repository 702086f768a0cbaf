"""Parameter-tree payloads in the checkpointer's on-disk format."""
