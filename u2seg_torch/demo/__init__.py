"""The demo of the port (counterpart of the repository's ``demo/``)."""
