"""Command-line entry points (counterpart of the JAX package's ``apps``)."""
