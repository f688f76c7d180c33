"""Frozen copy of the area model."""
