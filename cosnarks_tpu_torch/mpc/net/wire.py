"""Typed binary wire format for party-to-party messages — no pickle (port
of cosnarks_tpu.mpc.net.wire).

The round-1 transport pickled pytrees, which hands every peer arbitrary
code execution (the reference serializes with bincode over TLS,
mpc-net/src/tls.rs). This is the replacement: a small self-describing
tag-length-value encoding covering exactly the value shapes MPC messages
use — numpy arrays of whitelisted dtypes, python ints (share limbs /
BigUint binary shares), bytes, strings, bools, None, and
lists/tuples/dicts thereof. Decoding only ever allocates data, never
executes it, and enforces a maximum frame length (the reference's
max_frame_length, mpc-net/src/config.rs:171).

A torch tensor is encoded as its CPU numpy array, so the same values give
the same bytes as in the JAX package; decoding gives numpy arrays, and
`tensors` turns them into tensors on a network's device.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_FRAME_LENGTH = 1 << 30  # 1 GiB default cap, mirrors NetworkConfig

_DTYPES = [
    np.dtype(d)
    for d in (
        "uint8", "uint16", "uint32", "uint64",
        "int8", "int16", "int32", "int64",
        "float32", "float64", "bool",
    )
]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}

_T_ARR = 0x01
_T_INT = 0x02
_T_LIST = 0x03
_T_TUPLE = 0x04
_T_DICT = 0x05
_T_STR = 0x06
_T_NONE = 0x07
_T_BOOL = 0x08
_T_BYTES = 0x09


class WireError(ValueError):
    pass


def _enc(obj, out: list):
    if obj is None:
        out.append(bytes([_T_NONE]))
    elif isinstance(obj, bool):
        out.append(bytes([_T_BOOL, int(obj)]))
    elif isinstance(obj, int):
        sign = 1 if obj < 0 else 0
        raw = abs(obj).to_bytes((abs(obj).bit_length() + 7) // 8 or 1, "little")
        out.append(struct.pack("<BBI", _T_INT, sign, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(struct.pack("<BI", _T_BYTES, len(raw)))
        out.append(raw)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(raw)))
        out.append(raw)
    elif isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(obj))
        if arr.dtype not in _DTYPE_CODE:
            raise WireError(f"dtype {arr.dtype} not on wire whitelist")
        out.append(
            struct.pack(
                "<BBB", _T_ARR, _DTYPE_CODE[arr.dtype], arr.ndim
            )
        )
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(arr.tobytes())
    elif isinstance(obj, (list, tuple)):
        tag = _T_LIST if isinstance(obj, list) else _T_TUPLE
        out.append(struct.pack("<BI", tag, len(obj)))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, dict):
        out.append(struct.pack("<BI", _T_DICT, len(obj)))
        for k, v in obj.items():
            if not isinstance(k, (str, int)):
                raise WireError("dict keys must be str or int on the wire")
            _enc(k, out)
            _enc(v, out)
    else:
        raise WireError(f"cannot serialize {type(obj)} for the wire")


_TORCH_DTYPES = {getattr(torch, d.name) for d in _DTYPES
                 if hasattr(torch, d.name)}


def encoded_size(obj) -> int:
    """len(encode(obj)), counted from the message's types and shapes: a
    device tensor is not copied to the host."""
    if obj is None:
        return 1
    if isinstance(obj, bool):
        return 2
    if isinstance(obj, int):
        return 6 + ((abs(obj).bit_length() + 7) // 8 or 1)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return 5 + memoryview(obj).nbytes
    if isinstance(obj, str):
        return 5 + len(obj.encode("utf-8"))
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _TORCH_DTYPES:
            raise WireError(f"dtype {obj.dtype} not on wire whitelist")
        # encode's np.ascontiguousarray makes a 0-d array 1-d
        return (3 + 4 * max(obj.dim(), 1)
                + obj.numel() * obj.element_size())
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype not in _DTYPE_CODE:
            raise WireError(f"dtype {arr.dtype} not on wire whitelist")
        return 3 + 4 * max(arr.ndim, 1) + arr.nbytes
    if isinstance(obj, (list, tuple)):
        return 5 + sum(encoded_size(x) for x in obj)
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, (str, int)):
                raise WireError("dict keys must be str or int on the wire")
        return 5 + sum(encoded_size(k) + encoded_size(v)
                       for k, v in obj.items())
    raise WireError(f"cannot serialize {type(obj)} for the wire")


def _need(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise WireError("truncated frame")
    return pos + n


def _dec(data: bytes, pos: int):
    end = _need(data, pos, 1)
    tag = data[pos]
    pos = end
    if tag == _T_NONE:
        return None, pos
    if tag == _T_BOOL:
        end = _need(data, pos, 1)
        return bool(data[pos]), end
    if tag == _T_INT:
        end = _need(data, pos, 5)
        sign, ln = struct.unpack_from("<BI", data, pos)
        pos = end
        end = _need(data, pos, ln)
        v = int.from_bytes(data[pos:end], "little")
        return (-v if sign else v), end
    if tag in (_T_BYTES, _T_STR):
        end = _need(data, pos, 4)
        (ln,) = struct.unpack_from("<I", data, pos)
        pos = end
        end = _need(data, pos, ln)
        raw = data[pos:end]
        return (raw.decode("utf-8") if tag == _T_STR else raw), end
    if tag == _T_ARR:
        end = _need(data, pos, 2)
        code, ndim = struct.unpack_from("<BB", data, pos)
        pos = end
        if code >= len(_DTYPES):
            raise WireError("unknown dtype code")
        end = _need(data, pos, 4 * ndim)
        shape = struct.unpack_from(f"<{ndim}I", data, pos)
        pos = end
        dtype = _DTYPES[code]
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        nbytes = count * dtype.itemsize
        end = _need(data, pos, nbytes)
        arr = np.frombuffer(data[pos:end], dtype=dtype).reshape(shape).copy()
        return arr, end
    if tag in (_T_LIST, _T_TUPLE, _T_DICT):
        end = _need(data, pos, 4)
        (count,) = struct.unpack_from("<I", data, pos)
        pos = end
        if tag == _T_DICT:
            d = {}
            for _ in range(count):
                k, pos = _dec(data, pos)
                v, pos = _dec(data, pos)
                d[k] = v
            return d, pos
        items = []
        for _ in range(count):
            v, pos = _dec(data, pos)
            items.append(v)
        return (items if tag == _T_LIST else tuple(items)), pos
    raise WireError(f"unknown wire tag {tag:#x}")


def encode(obj, max_frame_length: int | None = None) -> bytes:
    """Message -> bytes. Device tensors are fetched to host; namedtuples are
    flattened to plain tuples (receivers treat messages structurally).
    The frame cap is per-call (each network threads its own configured
    max_frame_length); the module constant is only the default."""
    out: list = []
    _enc(obj, out)
    data = b"".join(out)
    cap = MAX_FRAME_LENGTH if max_frame_length is None else max_frame_length
    if len(data) > cap:
        raise WireError(
            f"frame of {len(data)} bytes exceeds max_frame_length={cap}"
        )
    return data


def tensors(obj, device: torch.device):
    """A decoded message with every numpy array in it, inside lists, tuples
    and dicts too, turned into a tensor of the same dtype on `device`;
    ints, bytes, strings, bools and None stay Python objects. The socket
    transports hand messages to the protocols this way, as LocalNetwork
    hands over the tensors that were sent."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(tensors(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: tensors(v, device) for k, v in obj.items()}
    return obj


def decode(data: bytes, max_frame_length: int | None = None):
    cap = MAX_FRAME_LENGTH if max_frame_length is None else max_frame_length
    if len(data) > cap:
        raise WireError("incoming frame exceeds max_frame_length")
    obj, pos = _dec(bytes(data), 0)
    if pos != len(data):
        raise WireError("trailing bytes in frame")
    return obj
