"""Models over packed batches, and the registry."""
