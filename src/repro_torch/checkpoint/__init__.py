"""Checkpoint storage of the port."""
