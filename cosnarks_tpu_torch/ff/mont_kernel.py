"""K1: batched Montgomery multiplication on Hopper, and its plain version.

Replaces the Pallas kernels of cosnarks_tpu/ff/pallas_mont.py, `_mul_call`
(row-major tiles, batches below 4096) and `_mul_call_lm` (limb-major slabs,
batches of 4096 and more). Their split only existed to fill the TPU's
sublanes; here one kernel serves every batch size, from the 3 products of
an Fq2 multiply to the 2^15-2^17 of an NTT stage or a G2 MSM step.

What bounds it on the card: memory. The int64 limb boundary moves 384 bytes
per product (two 128-byte inputs, one 128-byte output) for 264 32-bit
multiplies at eight words (BN254, BLS12-381 Fr), 576 bytes for 588 at
twelve (BLS12-381 Fq), so an H100 (3.35 TB/s, 132 SMs x 64 IMAD/clock) is
bytes-bound by ~7x and ~5x. So the kernel's task is to move those bytes at
the card's rate; one thread per element, loading its limbs 8 bytes at a time
128 bytes from its neighbours', reaches 30 % of it (PERF.md).

Kernel (csrc/mont_mul.cu): a persistent grid of `blocks` blocks walks over
tiles of `tile` consecutive elements, block b taking tiles b, b + blocks,
.... Each block copies both operand tiles into shared memory with coalesced
16-byte cp.async copies (double-buffered, so the next tile's copies overlap
this tile's products), each thread runs one CIOS product in registers on
32-bit words, and the block stores the tile with coalesced 16-byte stores.
R stays 2^(16 nlimbs), so the output limbs equal `mul_plain`'s exactly.
The kernel is built once per width (`_build.load("mont_mul", words)`);
`mul` launches the build of its field's width.
`mul_geometry` picks tile and blocks, and `mul_tiles` spells out the walk
that the kernel makes, so a CPU test can check that it covers every element
once.

Dispatch: CPU tensors take `mul_plain`; CUDA tensors launch the kernel or
raise. `mul.launches[(words, 0)]` counts launches at each width,
`mul.sizes` their batch sizes by power of two and `mul.shapes` by exact
product count, `((words, 0), products)` (see `count`).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build
from .mont import mul_plain
from .spec import Field

__all__ = ["mul", "mul_plain", "field_params", "field_words", "count",
           "size_bucket", "mul_geometry", "mul_tiles"]

_count_lock = threading.Lock()


def size_bucket(total: int) -> int:
    """The power of two at or above `total` (1 for a single item)."""
    return 1 << max(0, total - 1).bit_length()


def count(wrapper, mode: int, total: int, shape=None):
    """Add one to `wrapper.launches[mode]` and to
    `wrapper.sizes[(mode, size_bucket(total))]`, and with a `shape` tuple
    to `wrapper.shapes[(mode, *shape)]`. Every kernel wrapper calls this
    right after its kernel launched, and nowhere else; `launches` holds one
    count per mode (op) of the kernel, `sizes` the histogram of the
    launches' batch sizes (`total`: products, points, fold lanes or
    windows), `shapes` the exact launch shapes of a wrapper that files
    them. The kernel wrappers pass mode = (words, op), so the two widths
    of a kernel count apart; the point kernels (ec_kernels) add the curve,
    so that two curves of one width count apart too."""
    with _count_lock:
        wrapper.launches[mode] = wrapper.launches.get(mode, 0) + 1
        key = (mode, size_bucket(total))
        wrapper.sizes[key] = wrapper.sizes.get(key, 0) + 1
        if shape is not None:
            key = (mode,) + tuple(shape)
            wrapper.shapes[key] = wrapper.shapes.get(key, 0) + 1


def key_str(mode) -> str:
    """A `count` mode, (words, op) or (words, op, curve), as a JSON key:
    "8w:0", "8w:0:bn254_g1"."""
    return f"{mode[0]}w:" + ":".join(str(k) for k in mode[1:])


def field_words(field: Field) -> int:
    """32-bit words per element of `field` in the kernels: 8 for 16-limb
    fields (BN254, BLS12-381 Fr), 12 for 24-limb ones (BLS12-381 Fq); the
    kernels are built for these two widths."""
    if field.nlimbs not in (16, 24):
        raise ValueError(f"CUDA kernels take 16- or 24-limb fields, not "
                         f"{field}")
    return field.nlimbs // 2


def field_params(field: Field):
    """The kernels' FieldParams block: p and R mod p as NW 32-bit words
    each, then -p^-1 mod 2^32 (csrc/field.cuh), NW = field_words(field)."""
    nw = field_words(field)
    words = [(field.p >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    words += [(field.R >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    words.append((-pow(field.p, -1, 1 << 32)) % (1 << 32))
    return (ctypes.c_uint32 * (2 * nw + 1))(*words)


def check_operands(tensors, nlimbs: int, device: torch.device):
    """Raise unless every tensor is a contiguous int64 CUDA tensor on
    `device` whose last axis holds `nlimbs` limbs."""
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {device}, got "
                             f"{t.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64 limbs, got {t.dtype}")
        if t.shape[-1] != nlimbs:
            raise ValueError(f"expected {nlimbs} limbs, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


def check_aligned(tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    that copy tiles in 16-byte pieces need it)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("expected tensors aligned to 16 bytes")


def launch(fn, *args):
    """Call a kernel's C entry point on the current stream; raise if the
    launch reported an error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch failed: error {err}")


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


# Elements per tile (one per thread of a block) and resident blocks per SM
# (a block holds two stages of two tiles in padded rows: 72 KB at a tile of
# 128 and eight words, 104 KB at twelve). scripts/torch_k1_tile_sweep.py
# timed tiles of 64-256 at 1-6 blocks per SM on an H100 at eight words:
# 128 x 1 was the fastest or within 1.4 % of it at 2^15, 2^17 and 2^20
# products. Twelve words take the same geometry.
MUL_TILE = 128
MUL_BLOCKS_PER_SM = 1


def element_bytes(words: int = 8) -> int:
    """One element at the int64 limb boundary: 2 x words limbs of 8 bytes
    (128 bytes at eight words, 192 at twelve)."""
    return 2 * words * 8


def mul_geometry(total: int, sms: int):
    """(tile, blocks) of K1's persistent grid for `total` products on a
    card with `sms` SMs, at either width: one block per tile up to
    MUL_BLOCKS_PER_SM blocks per SM."""
    ntiles = -(-total // MUL_TILE)
    return MUL_TILE, min(ntiles, MUL_BLOCKS_PER_SM * sms)


def mul_tiles(total: int, tile: int, blocks: int, words: int = 8):
    """The kernel's walk over the elements, as (block, first, count, nbytes)
    per tile in the order each block takes them: block b takes tiles b,
    b + blocks, ...; a tile covers `count` elements from `first` and copies
    `nbytes` bytes per operand (the last tile is ragged)."""
    ntiles = -(-total // tile)
    return [(blk, t * tile, min(tile, total - t * tile),
             min(tile, total - t * tile) * element_bytes(words))
            for blk in range(blocks) for t in range(blk, ntiles, blocks)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mul(field: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p for canonical limb tensors of one shape."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(field, a, b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    check_operands((a, b), field.nlimbs, a.device)
    check_aligned((a, b))
    out = torch.empty_like(a)
    words = field_words(field)
    total = a.numel() // field.nlimbs
    if total == 0:
        return out
    tile, blocks = mul_geometry(total, sm_count(a.device.index))
    lib = _build.load("mont_mul", words)
    with torch.cuda.device(a.device):
        launch(lib.cosnarks_mont_mul, ptr(a), ptr(b), ptr(out),
               ctypes.c_int64(total), ctypes.c_int(tile),
               ctypes.c_int(blocks), field_params(field))
    count(mul, (words, 0), total, shape=(total,))
    return out


mul.launches = {}
mul.sizes = {}
mul.shapes = {}
