"""Synthetic weights and checkpoints for tests and the chip smoke."""
