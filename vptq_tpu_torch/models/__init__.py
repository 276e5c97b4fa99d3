"""Decoder and checkpoint loader of the port."""
