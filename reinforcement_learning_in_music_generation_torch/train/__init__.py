"""Training loops of the port (counterpart of the JAX package's ``train``)."""
