"""Seeded synthetic corpora (numpy, host side)."""
