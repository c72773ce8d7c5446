"""Int8 KV-cache quantization (port of ``dlrover_tpu/ops/kv_quant.py``).

One f32 scale per KV head per cache row (``amax / 127`` over the
head_dim vector), symmetric round-to-nearest. A row is written once, so
its scale is computed at append time and never changes. Dequantization
happens at the read site: folded into the decode kernel's math
(``ops/decode_attention.py``), or materialized by
:func:`dequantize_kv` for the prefill's plain attention.

The wire format (:func:`kv_to_wire` / :func:`kv_from_wire`) carries a
span of KV rows between serving replicas as bytes, byte for byte the
reference's: the same header, the same int8 quantization.
"""

import json
import struct

import numpy as np
import torch

# Scales of all-zero rows would be 0 -> 0/0 at dequant; clamp to a
# denormal-free floor instead (the quantized values are 0 either way).
_SCALE_FLOOR = 1e-20


def quantize_kv(x: torch.Tensor):
    """x [..., d] float -> (q int8 [..., d], scale f32 [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # A true f32 division, as the reference's: CUDA turns a division by
    # a Python scalar into a product with its reciprocal, which differs
    # in the last bit for some amax (and then the wire's bytes differ).
    scale = torch.clamp(amax / torch.full_like(amax, 127.0),
                        min=_SCALE_FLOOR)
    # torch.round is round-half-to-even, as jnp.round.
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32):
    """Materializing inverse (prefill's view of an int8 cache)."""
    return (q.float() * scale[..., None]).to(dtype)


def bytes_per_head_row(head_dim: int, kv_dtype: str,
                       fp_itemsize: int = 2) -> int:
    """Device-memory bytes one KV head's cache row costs: int8 values
    plus one f32 scale, or ``head_dim * fp_itemsize`` for fp caches."""
    if kv_dtype == "int8":
        return head_dim + 4
    return head_dim * fp_itemsize


# ---------------------------------------------------------------------------
# Pure-bytes wire format (block migration between fleet replicas)
# ---------------------------------------------------------------------------
#
# Layout: MAGIC (4B) | header_len (u32 LE) | json header | kq | vq | ks | vs
# with kq/vq int8 C-order and ks/vs f32 LE C-order. The header records
# the int8 payload shape, the scale shape, and the SOURCE cache dtype
# (the reference's ``str(dtype)``: "bfloat16", "float32", "int8"), so
# the importer knows whether dequantization reconstructs the original
# cache exactly (int8 source) or to within the amax/254 quantization
# bound (fp source).

_WIRE_MAGIC = b"KVW1"


def wire_dtype_name(dtype) -> str:
    """The header's ``src_dtype`` for a torch or numpy dtype: numpy's
    name ("float32", "int8"; ``ml_dtypes``' "bfloat16"), torch's without
    its ``torch.`` prefix."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def wire_header(shape, scale_shape, src_dtype: str) -> bytes:
    """MAGIC | u32 | json header, in the reference's key order."""
    header = json.dumps(
        {
            "v": 1,
            "shape": list(shape),
            "scale_shape": list(scale_shape),
            "src_dtype": src_dtype,
        }
    ).encode()
    return b"".join([_WIRE_MAGIC, struct.pack("<I", len(header)), header])


def _as_tensor(a) -> torch.Tensor:
    """A numpy float array (``ml_dtypes`` bf16 included, through a uint16
    view: numpy has no bf16 of its own) or a tensor -> a tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)  # a writable copy (wire views are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def kv_to_wire(k, v, k_scale=None, v_scale=None) -> bytes:
    """Pack a (k, v) KV span into a self-describing byte string.

    Floating inputs (numpy, or tensors on any device) are int8-quantized
    here (:func:`quantize_kv`), scales inline; int8 inputs must arrive
    WITH their scales and pass through bit-exact. Shapes are arbitrary
    ``[..., d]`` as long as k and v match."""
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if wire_dtype_name(k.dtype) == "int8":
        if k_scale is None or v_scale is None:
            raise ValueError("int8 KV requires k_scale and v_scale")
        parts = [_as_tensor(k), _as_tensor(v),
                 _as_tensor(k_scale).float(), _as_tensor(v_scale).float()]
        src_dtype = "int8"
    else:
        if k_scale is not None or v_scale is not None:
            raise ValueError("scales only accompany int8 KV")
        kq, ks = quantize_kv(_as_tensor(k))
        vq, vs = quantize_kv(_as_tensor(v))
        parts = [kq, vq, ks, vs]
        src_dtype = wire_dtype_name(k.dtype)
    kq, vq, ks, vs = parts
    if tuple(ks.shape) != tuple(kq.shape[:-1]) or (
            tuple(vs.shape) != tuple(vq.shape[:-1])):
        raise ValueError(
            f"scale shape {tuple(ks.shape)} does not match KV rows "
            f"{tuple(kq.shape[:-1])}"
        )
    return wire_header(kq.shape, ks.shape, src_dtype) + wire_body(*parts)


def wire_body(kq, vq, ks, vs) -> bytes:
    """kq | vq | ks | vs as bytes, through ONE device-to-host copy: the
    four tensors are packed into one byte buffer where they live (the
    card, for an engine's export), then copied out."""
    flat = torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                      for t in (kq, vq, ks, vs)])
    return flat.cpu().numpy().tobytes()


def kv_from_wire(buf):
    """Inverse of :func:`kv_to_wire`.

    Returns ``(kq, vq, ks, vs, header)`` as numpy arrays: always int8
    values + f32 scales; the importer dequantizes only when its
    destination cache is fp. ``kv_to_wire(*kv_from_wire(b)[:4])`` is
    byte-identical to ``b``."""
    header, off = _parse_header(buf)
    shape = tuple(header["shape"])
    scale_shape = tuple(header["scale_shape"])
    n_q, n_s = _wire_sizes(buf, off, shape, scale_shape)
    kq = np.frombuffer(buf, np.int8, n_q, off).reshape(shape)
    off += n_q
    vq = np.frombuffer(buf, np.int8, n_q, off).reshape(shape)
    off += n_q
    ks = np.frombuffer(buf, "<f4", n_s, off).reshape(scale_shape)
    off += 4 * n_s
    vs = np.frombuffer(buf, "<f4", n_s, off).reshape(scale_shape)
    return kq, vq, ks, vs, header


def kv_from_wire_tensors(buf, device):
    """:func:`kv_from_wire` onto ``device``: ``(kq, vq, ks, vs,
    header)`` as tensors viewing one buffer. The body takes one host
    copy, into pinned memory when ``device`` is a card, and one
    host-to-device copy from there."""
    header, off = _parse_header(buf)
    shape = tuple(header["shape"])
    scale_shape = tuple(header["scale_shape"])
    n_q, n_s = _wire_sizes(buf, off, shape, scale_shape)
    n = len(buf) - off
    body = torch.empty(n, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")
    body.numpy()[:] = np.frombuffer(buf, np.uint8, n, off)
    body = body.to(device, non_blocking=True)
    kq = body[:n_q].view(torch.int8).view(shape)
    vq = body[n_q:2 * n_q].view(torch.int8).view(shape)
    ks = body[2 * n_q:2 * n_q + 4 * n_s].view(torch.float32).view(
        scale_shape)
    vs = body[2 * n_q + 4 * n_s:].view(torch.float32).view(scale_shape)
    return kq, vq, ks, vs, header


def _parse_header(buf):
    if bytes(buf[:4]) != _WIRE_MAGIC:
        raise ValueError("bad KV wire magic")
    (hlen,) = struct.unpack_from("<I", buf, 4)
    off = 8
    header = json.loads(bytes(buf[off:off + hlen]).decode())
    return header, off + hlen


def _wire_sizes(buf, off, shape, scale_shape):
    n_q = int(np.prod(shape, dtype=np.int64)) if shape else 1
    n_s = int(np.prod(scale_shape, dtype=np.int64)) if scale_shape else 1
    want = off + 2 * n_q + 2 * 4 * n_s
    if len(buf) != want:
        raise ValueError(f"KV wire truncated: {len(buf)} != {want}")
    return n_q, n_s
