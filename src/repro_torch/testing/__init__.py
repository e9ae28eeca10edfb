"""Test-support programs for the port (the paper's Benchpress suite)."""
