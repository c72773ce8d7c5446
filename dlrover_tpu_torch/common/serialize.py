"""Restricted unpickling for checkpoint metadata and the agent's UDS
messages (the port's copy of ``dlrover_tpu/common/serialize.py``).

Shared-memory images, ``proc-<pid>.meta`` files and UDS requests are
pickles, and a pickle can name any callable. The loader here admits
value constructors of ``builtins`` and the classes of the port's own
modules (``ShardMeta``, ``LeafMeta``, ``SaveEvent``), nothing else: no
function, and no JAX ``PyTreeDef`` (the port's tree spec is made of
builtins, see ``flash_ckpt/shm_handler.py``). The JAX package's
``ShardMeta`` and ``LeafMeta`` (the same fields) load as the port's, so
the port reads that package's ``proc-<pid>.meta`` files; the tree
definition they carry stays pickled bytes, never loaded.
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
        "object", "NoneType",
    }
)


# The reference's checkpoint metadata classes, read as the port's.
_REFERENCE_META = ("dlrover_tpu.flash_ckpt.shm_handler",
                   frozenset({"ShardMeta", "LeafMeta"}))


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _ALLOWED_BUILTINS:
            return getattr(importlib.import_module(module), name)
        if module == _REFERENCE_META[0] and name in _REFERENCE_META[1]:
            module = "dlrover_tpu_torch.flash_ckpt.shm_handler"
        if module.startswith(_PORT_PREFIX):
            obj = getattr(importlib.import_module(module), name, None)
            # Classes only: REDUCE on an arbitrary callable of the port
            # is as much a gadget as one of the standard library.
            if isinstance(obj, type):
                return obj
        raise pickle.UnpicklingError(
            f"blocked unpickle of {module}.{name}: not a checkpoint type"
        )


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads_pytree(data: bytes) -> Any:
    """Restricted unpickle of checkpoint metadata or a UDS message."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()
