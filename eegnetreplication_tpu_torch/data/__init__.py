"""Processed-trial containers and loaders."""
