"""Example graphs on the port's SDK (counterparts of the repository's
``examples/``)."""
