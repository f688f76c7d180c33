"""Frozen copy of the genome encoding."""
