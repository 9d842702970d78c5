"""Data layer: the GDF reader and writer, preprocessing, epoching, label
verification, and the processed-trial containers and loaders."""
