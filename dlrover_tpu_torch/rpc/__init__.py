"""The control plane's RPC transport (the port's copy of
``dlrover_tpu/rpc``)."""
