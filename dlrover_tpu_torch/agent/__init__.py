"""The agent side of the port: the elastic agent, its master client and
rendezvous, its monitors, and the node check's probe worker."""
