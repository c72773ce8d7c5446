"""The agent side of the port: so far the node check's probe worker."""
