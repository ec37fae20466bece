"""Multi-device runs on the data axis (the JAX package's parallel/)."""
