"""The batch-mode capacity server, its config schema and election."""
