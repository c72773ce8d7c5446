"""Structured training events (the port's copy of
``dlrover_tpu/training_event``)."""

from dlrover_tpu_torch.training_event.emitter import (  # noqa: F401
    DurationSpan,
    Event,
    EventEmitter,
    get_emitter,
)
from dlrover_tpu_torch.training_event.predefined import (  # noqa: F401
    AgentEvents,
    MasterEvents,
    TrainerEvents,
)
