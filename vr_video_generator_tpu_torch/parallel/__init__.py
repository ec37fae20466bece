"""Multi-device runs: the data and model axes, and multi-host (the JAX
package's parallel/)."""
