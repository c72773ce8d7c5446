"""Failure and hang diagnosis (the port's copy of
``dlrover_tpu/diagnosis``)."""
