"""The port's profiler daemon (``dlrover_tpu/tpu_timer``): the native
runtime's bridge, Python-side tracing, device capture over
``torch.profiler``, native stacks, analysis and the fetch tool."""

from dlrover_tpu_torch.tpu_timer.bridge import (  # noqa: F401
    SpanKind,
    TpuTimer,
    get_timer,
)
