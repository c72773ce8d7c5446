"""Meshes and sharding rules (the port of ``dlrover_tpu/parallel``)."""
