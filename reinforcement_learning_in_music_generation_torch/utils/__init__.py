"""Logging and checkpoints of the port (counterpart of the JAX package's
``utils``)."""
