"""Song generation (counterpart of the JAX package's ``generate``)."""
