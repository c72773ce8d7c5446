"""Environment-variable helpers."""

import os

_WARNED_CHOICES: set = set()


def resolve_env_choice(name: str, allowed, default: str) -> str:
    """Env knob constrained to ``allowed`` values, warning ONCE per
    unrecognized value and falling back to ``default`` — a typo in a
    kernel A/B knob must be loud, or the experiment silently measures
    the wrong path."""
    raw = os.environ.get(name, default).lower()
    if raw in allowed:
        return raw
    if (name, raw) not in _WARNED_CHOICES:
        _WARNED_CHOICES.add((name, raw))
        from dlrover_tpu_torch.common.log import logger

        logger.warning(
            "%s=%r is not one of %s; falling back to %r",
            name, raw, tuple(allowed), default,
        )
    return default
