"""Command line of the port (``soap3dp-torch``)."""
