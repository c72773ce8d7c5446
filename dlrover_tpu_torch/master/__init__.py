"""The job master of the port (its copy of ``dlrover_tpu/master``): the
``--platform local`` path, ``python -m dlrover_tpu_torch.master.main``."""
