"""Restricted unpickling for control-plane messages, checkpoint metadata
and the agent's UDS messages (the port's copy of
``dlrover_tpu/common/serialize.py``).

The wire between master and agents, shared-memory images,
``proc-<pid>.meta`` files and UDS requests are pickles, and a pickle can
name any callable. Two loaders keep that shut:

- ``loads`` (the RPC wire) admits value constructors of ``builtins``
  and the classes of the message modules (``_MESSAGE_MODULES``: the
  ``comm`` requests and responses, and the diagnosis data and actions a
  heartbeat carries back), nothing else.
- ``loads_pytree`` (checkpoint metadata, UDS requests) admits the same
  builtins and the classes of any of the port's modules (``ShardMeta``,
  ``LeafMeta``, ``SaveEvent``): no function, and no JAX ``PyTreeDef``
  (the port's tree spec is made of builtins, see
  ``flash_ckpt/shm_handler.py``). The JAX package's ``ShardMeta`` and
  ``LeafMeta`` (the same fields) load as the port's, so the port reads
  that package's ``proc-<pid>.meta`` files; the tree definition they
  carry stays pickled bytes, never loaded.
"""

import importlib
import io
import pickle
from typing import Any

_PORT_PREFIX = "dlrover_tpu_torch."

# ``builtins`` is not admitted wholesale: builtins.eval/exec/getattr are
# the classic pickle gadgets. Only value constructors messages use.
_ALLOWED_BUILTINS = frozenset(
    {
        "bool", "int", "float", "complex", "str", "bytes", "bytearray",
        "list", "tuple", "dict", "set", "frozenset", "slice", "range",
        "object", "NoneType", "Exception",
    }
)

# The modules whose classes travel on the master <-> agent wire.
_MESSAGE_MODULES = frozenset(
    {
        "dlrover_tpu_torch.common.comm",
        "dlrover_tpu_torch.diagnosis.diagnosis_data",
        "dlrover_tpu_torch.diagnosis.actions",
    }
)

# The reference's checkpoint metadata classes, read as the port's.
_REFERENCE_META = ("dlrover_tpu.flash_ckpt.shm_handler",
                   frozenset({"ShardMeta", "LeafMeta"}))


def _port_class(module: str, name: str):
    obj = getattr(importlib.import_module(module), name, None)
    # Classes only: REDUCE on an arbitrary callable of the port is as
    # much a gadget as one of the standard library.
    return obj if isinstance(obj, type) else None


class _RestrictedUnpickler(pickle.Unpickler):
    """The RPC wire's loader: builtins and the message classes."""

    what = "control-plane"

    def _admits(self, module: str) -> bool:
        return module in _MESSAGE_MODULES

    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _ALLOWED_BUILTINS:
            return getattr(importlib.import_module(module), name)
        if module == _REFERENCE_META[0] and name in _REFERENCE_META[1]:
            module = "dlrover_tpu_torch.flash_ckpt.shm_handler"
        if self._admits(module):
            obj = _port_class(module, name)
            if obj is not None:
                return obj
        raise pickle.UnpicklingError(
            f"blocked unpickle of {module}.{name}: not a {self.what} type"
        )


class _PytreeUnpickler(_RestrictedUnpickler):
    """Checkpoint metadata and UDS messages: any class of the port."""

    what = "checkpoint"

    def _admits(self, module: str) -> bool:
        return module.startswith(_PORT_PREFIX)


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes) -> Any:
    """Restricted unpickle of a control-plane message."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def loads_pytree(data: bytes) -> Any:
    """Restricted unpickle of checkpoint metadata or a UDS message."""
    return _PytreeUnpickler(io.BytesIO(data)).load()


class PickleSerializable:
    """Mixin for messages; kept trivially small so dataclasses stay plain."""

    def serialize(self) -> bytes:
        return dumps(self)

    @classmethod
    def deserialize(cls, data: bytes):
        return loads(data)
