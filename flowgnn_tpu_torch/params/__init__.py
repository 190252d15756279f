"""Model parameters: loaders, synthetic sets, conversion to tensors."""
