"""Frozen copies of compiler passes 1-2: precision assignment and fusion."""
