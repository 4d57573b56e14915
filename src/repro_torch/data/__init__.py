"""Data generators of the port (numpy only)."""
