"""Runtime linear layers of the port."""
