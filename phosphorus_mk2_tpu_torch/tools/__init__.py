"""Measurement tools of the port, each the counterpart of a script under
``tools/`` of the JAX package."""
