"""Shared utilities: logging and device selection."""
