"""Logging and checkpoints of the port (counterpart of the JAX package's
``utils``), and the stream its CUDA graphs are captured on."""
