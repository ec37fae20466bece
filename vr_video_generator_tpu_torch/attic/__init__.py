"""Kernels of the JAX package's attic: functions no CLI path runs, ported
with their plain versions so every TPU kernel has a Hopper counterpart."""
