"""Synthetic genomics inputs (a copy of the numpy-only reference module)."""
