"""Device mesh construction (the port of
``dlrover_tpu/parallel/mesh.py``).

The axis convention is the reference's (slowest-varying first; ``tp``
innermost):

- ``dcn``: data parallel across slices (only the batch rides it);
- ``dp``: data parallel / FSDP (params' embed dim sharded here, ZeRO);
- ``ep``: expert parallel, and an extra batch axis outside MoE layers;
- ``pp``: pipeline stages;
- ``sp``: sequence parallel (ring attention);
- ``tp``: tensor parallel (heads / mlp / vocab).

``MeshConfig`` and the shape helpers are copied as they are. A mesh is a
``torch.distributed`` ``DeviceMesh`` over the world's ranks in row-major
order, the reference's plain reshape of its devices off the TPU: rank
``r`` sits where the reference's device ``r`` sits, and a hybrid
``dcn`` mesh is that same reshape (no ICI/DCN topology to respect).
"""

import dataclasses
import math
from typing import List, Tuple

AXIS_NAMES = ("dcn", "dp", "ep", "pp", "sp", "tp")

# Batch is sharded over the slice axis plus both pure-data and expert
# axes.
BATCH_AXES = ("dcn", "dp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; product must equal the device count."""

    dp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    dcn: int = 1  # slices (inter-slice data parallel over DCN)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dcn, self.dp, self.ep, self.pp, self.sp, self.tp)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def data_parallel_size(self) -> int:
        return self.dcn * self.dp * self.ep

    @property
    def devices_per_slice(self) -> int:
        return self.num_devices // self.dcn

    def describe(self) -> str:
        return "x".join(
            f"{n}={s}" for n, s in zip(AXIS_NAMES, self.shape) if s > 1
        ) or "single"


def build_mesh(config: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the world with the six axis names in the
    reference's order. Raises the reference's ``ValueError`` when the
    world size is not ``config.num_devices``. A process that has not
    joined a process group gets a one-rank group (world of one), so a
    single card runs the same code as a larger world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)
    n = dist.get_world_size()
    if config.num_devices != n:
        raise ValueError(
            f"mesh {config.shape} needs {config.num_devices} devices, "
            f"have {n}"
        )
    return init_device_mesh(device_type, config.shape,
                            mesh_dim_names=AXIS_NAMES)


def parse_mesh(text: str, world: int) -> MeshConfig:
    """``"dp=2,tp=2"`` -> ``MeshConfig(dp=2, tp=2)``; an empty string is
    the reference worker's ``MeshConfig(dp=world)``."""
    if not text:
        return MeshConfig(dp=world)
    sizes = {}
    for part in text.split(","):
        name, _, size = part.partition("=")
        if name.strip() not in AXIS_NAMES:
            raise ValueError(f"mesh axis {name!r} not in {AXIS_NAMES}")
        sizes[name.strip()] = int(size)
    return MeshConfig(**sizes)


def factorize_devices(
    n: int,
    max_tp: int = 8,
    max_pp: int = 8,
    want_sp: bool = True,
    want_ep: bool = True,
) -> MeshConfig:
    """Pick a reasonable axis decomposition for ``n`` devices.

    Spreads factors of two round-robin over (tp, pp, sp, ep) — tp first
    each round so it grows fastest up to ``max_tp`` — and sends the
    remainder (including any odd factor) to dp. Note: configs with pp>1
    need ``trainer.pipeline.pipelined_forward``; pass ``max_pp=1`` when
    targeting the plain forward path.

    factorize_devices(8)  -> tp=2 pp=2 sp=2
    factorize_devices(64) -> tp=4 pp=4 sp=2 ep=2
    """
    sizes = {"tp": 1, "pp": 1, "sp": 1, "ep": 1}
    caps = {
        "tp": max_tp,
        "pp": max_pp,
        "sp": 2 if want_sp else 1,
        "ep": 2 if want_ep else 1,
    }
    remaining = n
    progress = True
    while remaining % 2 == 0 and remaining > 1 and progress:
        progress = False
        for ax in ("tp", "pp", "sp", "ep"):
            if remaining % 2 == 0 and remaining > 1 and (
                sizes[ax] * 2 <= caps[ax]
            ):
                sizes[ax] *= 2
                remaining //= 2
                progress = True
    return MeshConfig(dp=remaining, **sizes)


def legal_mesh_shapes(
    num_hosts: int, chips_per_host: int = 4
) -> List[Tuple[int, int]]:
    """Feasible (hosts, chips) configurations at or below ``num_hosts``.

    TPU slices only come in certain shapes (powers of two hosts for v5e
    pods); the elastic re-mesh path picks the largest entry still
    satisfiable after a host loss — the analogue of the reference's
    ``node_unit`` rounding (servicer.py:708).
    """
    shapes = []
    h = 1
    while h <= num_hosts:
        shapes.append((h, h * chips_per_host))
        h *= 2
    return shapes


def largest_legal_hosts(available_hosts: int, chips_per_host: int = 4) -> int:
    """Largest power-of-two host count <= available (0 if none)."""
    shapes = legal_mesh_shapes(available_hosts, chips_per_host)
    return shapes[-1][0] if shapes else 0


def mesh_config_for_slices(
    num_devices: int,
    num_slices: int = 1,
    max_tp: int = 8,
    max_pp: int = 1,
    want_sp: bool = False,
    want_ep: bool = False,
) -> MeshConfig:
    """Multi-slice mesh recipe: data parallel across slices over DCN
    (``dcn=num_slices``), everything else factorized INSIDE a slice so
    its collectives ride ICI. ``num_slices`` usually comes from
    ``DistributedContext.num_slices`` (node groups / node_unit).
    """
    if num_devices % max(num_slices, 1):
        raise ValueError(
            f"{num_devices} devices not divisible by {num_slices} slices"
        )
    per_slice = num_devices // max(num_slices, 1)
    intra = factorize_devices(
        per_slice, max_tp=max_tp, max_pp=max_pp,
        want_sp=want_sp, want_ep=want_ep,
    )
    return dataclasses.replace(intra, dcn=max(num_slices, 1))
