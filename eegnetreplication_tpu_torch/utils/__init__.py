"""Shared utilities: logging, device selection, FLOP accounting."""
