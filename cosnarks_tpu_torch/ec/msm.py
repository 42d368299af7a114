"""Multi-scalar multiplication (signed-digit Pippenger): PyTorch port of
cosnarks_tpu.ec.msm.

 1. signed c-bit window digits (|d| <= 2^(c-1); the sign rides in the sort
    payload and selects -Y in the point gather)
 2. per window, one sort of packed int64 keys (bucket | index | inf | sign).
    The index makes every key unique, so the order is fixed (the JAX
    package's 32-bit packing gives the same order where it applies; where
    it falls back to an unstable key-value sort, MSMs agree as points)
 3. bucket accumulation in chunks of K = 32 sorted entries per lane:
    level 0 through the K4 fold wrapper (`ec_kernels.level0_fold`), each
    later level with more than one chunk per window through the projective
    fold (`ec_kernels.proj_fold`), the last level in `_fold_levels_xla`
 4. weighted bucket reduction sum_b b*S_b by row/column tree sums and
    double suffix ladders (K3 projective adds)
 5. window Horner combine, then one projective -> Jacobian conversion

`_pippenger_wsums` + `_host_horner` is the package's other split: steps
1-3, then step 4 as one K6 launch (`ec_kernels.weighted_bucket_sum`:
segmented running sums across the card, at either field width), and
Horner on the host. msm() does not take it.

Unlike the TPU, where `pallas_ec.lm_geometry` decides whether a level tiles
into (8, 128) blocks, the CUDA fold launches at every level whose stream
spans more than one chunk per window; only the final single-chunk level runs
in `_fold_levels_xla`. More levels therefore run through K4 than on the
TPU. The same control flow runs on the CPU, where the fold wrapper takes its
plain version, so the CPU tests exercise what the card runs.

G2 (Fq2) MSMs take the step loop of `_level0_accumulate` and
`_fold_levels_xla` in torch ops, as the JAX package does.
"""

from __future__ import annotations

import torch

from ..ff.bigint import LIMB_BITS
from ..utils import timing
from . import curve as ec
from .curve import CurveSpec

I64 = torch.int64


def _raw_digits(spec: CurveSpec, scalars_std, c: int):
    """(N, nlimbs) standard-form scalars -> (nwin, N) raw c-bit digits,
    LSB window first. c <= LIMB_BITS (digits span <= 2 limbs)."""
    if c > LIMB_BITS:
        raise ValueError("window size must be <= limb width")
    f = spec.scalar_field
    nwin = -(-f.bits // c)
    mask = (1 << c) - 1
    outs = []
    for w in range(nwin):
        bit0 = w * c
        limb = bit0 // LIMB_BITS
        shift = bit0 % LIMB_BITS
        d = scalars_std[..., limb] >> shift
        if shift + c > LIMB_BITS and limb + 1 < f.nlimbs:
            d = d | (scalars_std[..., limb + 1] << (LIMB_BITS - shift))
        outs.append(d & mask)
    return torch.stack(outs)


def signed_digits(spec: CurveSpec, scalars_std, c: int):
    """Signed digit recoding: (nwin, N) digits in [-(2^(c-1)-1), 2^(c-1)]
    with sum_w d_w 2^(cw) = scalar."""
    f = spec.scalar_field
    nwin = -(-f.bits // c)
    top_max = (1 << (f.bits - (nwin - 1) * c)) - 1 + 1  # raw + carry
    if top_max > (1 << (c - 1)):
        raise ValueError(f"window {c} would overflow the top signed digit")
    raw = _raw_digits(spec, scalars_std, c)
    half = 1 << (c - 1)
    full = 1 << c
    outs = []
    carry = torch.zeros_like(raw[0])
    for w in range(nwin):
        v = raw[w] + carry
        over = v > half
        outs.append(torch.where(over, v - full, v))
        carry = over.to(I64)
    return torch.stack(outs)


CHUNK_K = 32  # points folded sequentially per lane per level


def _sort_by_bucket(bucket, sign, inf_in, c: int, N: int):
    """(nwin, N) bucket ids + sign bits + per-point infinity bits ->
    (order, sortedb, sorted_sign, sorted_inf), sorted by (bucket, index)."""
    idx_bits = max(1, (N - 1).bit_length())
    payload = ((torch.arange(N, dtype=I64, device=bucket.device)[None, :] << 2)
               | (inf_in.to(I64)[None, :] << 1)
               | sign.to(I64))
    keys = (bucket.to(I64) << (idx_bits + 2)) | payload
    skeys = torch.sort(keys, dim=1).values
    spay = skeys & ((1 << (idx_bits + 2)) - 1)
    sortedb = skeys >> (idx_bits + 2)
    order = spay >> 2
    sorted_sign = (spay & 1).to(torch.bool)
    sorted_inf = ((spay >> 1) & 1).to(torch.bool)
    return order, sortedb, sorted_sign, sorted_inf


def _window_buckets(spec: CurveSpec, pts, scalars_std, c: int):
    """Signed digits -> sorted buckets -> chunked segmented reduction:
    3 x (nwin, 2^(c-1), n) projective sums of buckets 1..2^(c-1)."""
    o = spec.ops
    X, Y, Z = pts
    N = X.shape[0]
    B = (1 << (c - 1)) + 1  # buckets 0..2^(c-1)
    inf_in = o.is_zero(Z)

    with timing.span("msm.digits"):
        digits = signed_digits(spec, scalars_std, c)  # (nwin, N)
    nwin = digits.shape[0]
    with timing.span("msm.sort"):
        order, sortedb, sorted_sign, sorted_inf = _sort_by_bucket(
            digits.abs(), digits < 0, inf_in, c, N)
    acc = _bucket_accumulate(spec, order, sortedb, sorted_sign, sorted_inf,
                             X, Y, B, nwin)
    return tuple(x[:, 1:] for x in acc)


def _pippenger_signed(spec: CurveSpec, pts, scalars_std, c: int):
    """Full MSM: window buckets -> weighted reduction -> Horner."""
    buckets = _window_buckets(spec, pts, scalars_std, c)
    with timing.span("msm.reduce"):
        wsums = _weighted_bucket_sum(spec, buckets)  # (nwin,)
    del buckets  # free before the combine, as an argument would be
    with timing.span("msm.combine"):
        acc = _horner_combine(spec, wsums, c)
    return ec.proj_to_jacobian(spec, acc)


def _pippenger_wsums(spec: CurveSpec, pts, scalars_std, c: int):
    """The other split: `_window_buckets` as in `_pippenger_signed`, then
    the per-window weighted bucket sums in one K6 launch
    (`ec_kernels.weighted_bucket_sum`); Horner is left to the host
    (`_host_horner`). Not used by msm(); the building block of a multi-card
    reduction. Returns 3 x (nwin, n) projective window sums."""
    from . import ec_kernels

    return ec_kernels.weighted_bucket_sum(
        spec, _window_buckets(spec, pts, scalars_std, c))


def _host_horner(spec: CurveSpec, wsums, c: int):
    """sum_w 2^(c*w) W_w on the host from projective window sums (a few KB
    to fetch); returns one Jacobian point (Z in {0, 1}) on wsums' device."""
    from . import host

    pts = ec.decode_points(spec, ec.proj_to_jacobian(spec, wsums))
    hc = host.host_curve(spec)
    acc = None
    for pt in reversed(pts):
        if acc is not None:
            for _ in range(c):
                acc = hc.double(acc)
        acc = hc.add(acc, hc.lift_affine(pt))
    single = ec.encode_points(spec, [hc.affine_ints(acc)],
                              device=wsums[0].device)
    return tuple(x[0] for x in single)


def _weighted_bucket_sum(spec: CurveSpec, buckets):
    """sum_j (j+1) * buckets[:, j] per window (projective points), by the
    weight split j = H*l + h:
      sum (H*l + h + 1) S[l,h] = H * sum_l l*R_l + sum_h (h+1)*C_h
    with R_l / C_h row / column tree sums."""
    nwin, W = buckets[0].shape[:2]
    if W & (W - 1):
        raise ValueError("bucket width must be a power of two")
    H = 1 << ((W - 1).bit_length() // 2)
    L = W // H
    s = tuple(x.reshape((nwin, L, H) + x.shape[2:]) for x in buckets)

    def tree_sum(pts, axis):
        m = pts[0].shape[axis]
        while m > 1:
            half = m // 2
            lo = tuple(x.narrow(axis, 0, half) for x in pts)
            hi = tuple(x.narrow(axis, half, m - half) for x in pts)
            pts = ec.proj_add(spec, lo, hi)
            m = half
        return tuple(x.squeeze(axis) for x in pts)

    rows = tree_sum(s, 2)  # (nwin, L): R_l = sum_h S[l, h]
    cols = tree_sum(s, 1)  # (nwin, H): C_h = sum_l S[l, h]
    w2 = tuple(x[:, 0] for x in _suffix_sums(spec, _suffix_sums(spec, cols)))
    rows1 = tuple(x[:, 1:] for x in rows)
    w1 = tuple(x[:, 0] for x in _suffix_sums(spec, _suffix_sums(spec, rows1)))
    for _ in range(H.bit_length() - 1):  # * H
        w1 = ec.proj_double(spec, w1)
    return ec.proj_add(spec, w1, w2)


def _pad_entries(keys, vals, B: int, nwin: int, K: int, spec):
    """Pad a (nwin, M) boundary stream to a multiple of K entries with
    bucket id B (beyond every real bucket) and identity points."""
    M = keys.shape[1]
    Mp = -(-M // K) * K
    if Mp != M:
        keys = torch.cat([keys, torch.full((nwin, Mp - M), B, dtype=I64,
                                           device=keys.device)], dim=1)
        inf = ec.proj_point_inf(spec, (nwin, Mp - M), device=keys.device)
        vals = tuple(torch.cat([v, i], dim=1) for v, i in zip(vals, inf))
    return keys, vals, Mp // K


def _fold_flags(keysT, validT):
    """Fold flags (K, L): bit0 changed, bit1 valid, bit2 save-prefix (the
    segment that started the chunk ends at this step)."""
    L = keysT.shape[1]
    dev = keysT.device
    changed = torch.cat([torch.zeros((1, L), dtype=torch.bool, device=dev),
                         keysT[1:] != keysT[:-1]], dim=0)
    isfirst = torch.cat([torch.ones((1, L), dtype=torch.bool, device=dev),
                         keysT[:-1] == keysT[0:1]], dim=0)
    return (changed.to(I64) | (validT.to(I64) << 1)
            | ((changed & isfirst).to(I64) << 2))


def _pack2(a):
    """(N, n) limbs -> (N, n/2) words, two 16-bit limbs per word."""
    return a[:, 0::2] | (a[:, 1::2] << 16)


def _level0_accumulate(spec: CurveSpec, order, sortedb, sorted_sign,
                       sorted_inf, X, Y, B: int, nwin: int):
    """Scatter-free first level: fold K sorted points per chunk, dumping
    the running sum per step; interior bucket sums are read back with one
    gather. Returns the (prefix, suffix) boundary stream for the next level
    plus the partially filled bucket array."""
    o = spec.ops
    K = CHUNK_K
    dev = order.device
    N = order.shape[1]
    pad = -N % K
    if pad:
        sortedb = torch.cat([sortedb, torch.full((nwin, pad), B, dtype=I64,
                                                 device=dev)], dim=1)
        order = torch.cat([order, torch.zeros((nwin, pad), dtype=I64,
                                              device=dev)], dim=1)
        sorted_sign = torch.cat([sorted_sign, torch.zeros(
            (nwin, pad), dtype=torch.bool, device=dev)], dim=1)
        sorted_inf = torch.cat([sorted_inf, torch.ones(
            (nwin, pad), dtype=torch.bool, device=dev)], dim=1)
        N += pad
    C = N // K
    w_idx = torch.arange(nwin, device=dev)[:, None]

    keys3 = sortedb.reshape(nwin, C, K)
    pos3 = order.reshape(nwin, C, K)
    sgn3 = sorted_sign.reshape(nwin, C, K)
    inf3 = sorted_inf.reshape(nwin, C, K)
    first_key = keys3[:, :, 0]

    if o.coord_ndim == 1:
        from . import ec_kernels

        L = nwin * C
        ncoord = X.shape[-1]
        NP = X.shape[0]
        keysT = keys3.permute(2, 0, 1).reshape(K, L)
        flat = pos3.permute(2, 0, 1).reshape(-1)
        sgnT = sgn3.permute(2, 0, 1).reshape(-1)
        # two limbs per word halves the random gather; the sign select is
        # folded into the gather: the source holds [Y ; -Y]
        qx = _pack2(X)[flat].T.reshape(ncoord // 2, K, L).contiguous()
        ycat = torch.cat([_pack2(Y), _pack2(o.neg(Y))], dim=0)
        qy = ycat[flat + sgnT.to(I64) * NP].T.reshape(
            ncoord // 2, K, L).contiguous()
        validT = ~inf3.permute(2, 0, 1).reshape(K, L)
        flags = _fold_flags(keysT, validT)
        buf, run, prefix = ec_kernels.level0_fold(spec, qx, qy, flags, K)
        buf = tuple(x.reshape(ncoord, K, nwin, C) for x in buf)
        run = tuple(x.reshape(ncoord, nwin, C).permute(1, 2, 0) for x in run)
        prefix = tuple(x.reshape(ncoord, nwin, C).permute(1, 2, 0)
                       for x in prefix)
        cur_key = keysT[K - 1].reshape(nwin, C)
        return _level0_tail(spec, sortedb, buf, run, prefix, first_key,
                            cur_key, B, nwin, K, w_idx, limb_major_buf=True)

    # Fq2 (G2): K steps of gather + projective mixed add in torch ops
    buf = [[] for _ in range(3)]
    run = ec.proj_point_inf(spec, (nwin, C), device=dev)
    prefix = run
    cur_key = first_key
    for t in range(K):
        k = keys3[:, :, t]
        flat = pos3[:, :, t].reshape(-1)
        qx = X[flat].reshape((nwin, C) + X.shape[1:])
        qy = Y[flat].reshape((nwin, C) + Y.shape[1:])
        qy = o.select(sgn3[:, :, t], o.neg(qy), qy)
        v_valid = ~inf3[:, :, t]
        one = o.one_like(qx)
        zero = o.zeros_like(qx)
        v_pt = (o.select(v_valid, qx, zero), o.select(v_valid, qy, one),
                o.select(v_valid, one, zero))
        changed = k != cur_key
        is_first = cur_key == first_key
        prefix = ec.select_point(spec, changed & is_first, run, prefix)
        for b, r in zip(buf, run):
            b.append(r)
        grown = ec.proj_madd(spec, run, (qx, qy), ~changed & v_valid)
        run = ec.select_point(spec, changed, v_pt, grown)
        cur_key = k
    buf = tuple(torch.stack(b) for b in buf)  # (K, nwin, C, ...)
    return _level0_tail(spec, sortedb, buf, run, prefix, first_key,
                        cur_key, B, nwin, K, w_idx)


def _bucket_bounds(sortedb, B: int):
    """Per-window bucket [start, end) in the sorted stream, from a
    histogram (bincount) and an exclusive cumsum (the JAX package builds
    the same counts with a one-hot matmul)."""
    nwin, N = sortedb.shape
    offs = torch.arange(nwin, device=sortedb.device)[:, None] * (B + 1)
    # a card's bincount waits twice, for the ids' least and largest
    with timing.blocking("msm.bucket_bounds", syncs=2):
        counts = torch.bincount((sortedb + offs).reshape(-1),
                                minlength=nwin * (B + 1))
    counts = counts.reshape(nwin, B + 1)[:, :B]
    starts = torch.cumsum(counts, dim=1) - counts
    return starts, starts + counts


def _level0_tail(spec: CurveSpec, sortedb, buf, run, prefix, first_key,
                 cur_key, B: int, nwin: int, K: int, w_idx,
                 limb_major_buf: bool = False, prev_buckets=None):
    """Shared fold-level epilogue: single-segment prefix fix, interior
    segment readback from the dense buffer, boundary (prefix, suffix)
    stream. buf: (K, nwin, C, ...) batch-last, or (ncoord, K, nwin, C)
    when limb_major_buf (the fold kernel's layout)."""
    single = cur_key == first_key
    prefix = ec.select_point(spec, single, run, prefix)

    starts, ends = _bucket_bounds(sortedb, B)
    end_idx = ends - 1
    interior = ((ends > starts) & (starts // K == end_idx // K)
                & (starts % K != 0) & (end_idx % K != K - 1))
    zero = torch.zeros_like(end_idx)
    t_idx = torch.where(interior, end_idx % K + 1, zero)
    c_idx = torch.where(interior, end_idx // K, zero)
    if limb_major_buf:
        gathered = tuple(bc[:, t_idx, w_idx, c_idx].permute(1, 2, 0)
                         for bc in buf)
    else:
        gathered = tuple(bc[t_idx, w_idx, c_idx] for bc in buf)
    if prev_buckets is None:
        prev_buckets = ec.proj_point_inf(spec, (nwin, B),
                                         device=sortedb.device)
    buckets = ec.select_point(spec, interior, gathered, prev_buckets)

    C = first_key.shape[1]
    suf_key = torch.where(single, first_key, cur_key)
    suffix = ec.select_point(
        spec, single, ec.proj_point_inf(spec, (nwin, C),
                                        device=sortedb.device), run)
    keys = torch.stack([first_key, suf_key], dim=2).reshape(nwin, 2 * C)
    vals = tuple(
        torch.stack([p, s], dim=2).reshape((nwin, 2 * C) + p.shape[2:])
        for p, s in zip(prefix, suffix))
    return {"keys": keys, "vals": vals, "buckets": buckets}


def _bucket_accumulate(spec: CurveSpec, order, sortedb, sorted_sign,
                       sorted_inf, X, Y, B: int, nwin: int):
    """Chunked segmented reduction of sorted (bucket, point) streams into
    (nwin, B) projective bucket sums. Level 0 dumps the running sum densely
    and reads interior segments back with one gather; later levels fold the
    2-per-chunk (prefix, suffix) boundary streams, shrinking by K/2 per
    level — through the projective fold while a window spans more than one
    chunk (G1), then `_fold_levels_xla`."""
    K = CHUNK_K
    with timing.span("msm.level0"):
        state0 = _level0_accumulate(spec, order, sortedb, sorted_sign,
                                    sorted_inf, X, Y, B, nwin)
    keys, vals, buckets = state0["keys"], state0["vals"], state0["buckets"]
    if spec.ops.coord_ndim == 1:
        while -(-keys.shape[1] // K) > 1:
            with timing.span("msm.fold"):
                keys, vals, buckets = _fold_level_mega(
                    spec, keys, vals, buckets, B, nwin, K)
    with timing.span("msm.fold_tail"):
        return _fold_levels_xla(spec, keys, vals, buckets, B, nwin)


def _fold_level_mega(spec: CurveSpec, keys, vals, buckets, B: int,
                     nwin: int, K: int):
    """One boundary-stream fold level through the projective fold: pad to a
    K multiple, build step-major limb-major slabs, fold, merge interior
    segments into `buckets`, emit the next stream."""
    from . import ec_kernels

    n = spec.ops.field.nlimbs
    keys, vals, C = _pad_entries(keys, vals, B, nwin, K, spec)
    L = nwin * C
    w_idx = torch.arange(nwin, device=keys.device)[:, None]
    keys3 = keys.reshape(nwin, C, K)
    keysT = keys3.permute(2, 0, 1).reshape(K, L)
    first_key = keys3[:, :, 0]
    # slabs (n, K, L): slab[:, t, w*C + c] = vals[w, c*K + t]
    slabs = tuple(
        v.reshape(nwin, C, K, n).permute(3, 2, 0, 1).reshape(n, K, L)
        .contiguous() for v in vals)
    valid = (vals[2] != 0).any(-1)  # identity entries: Z == 0
    validT = valid.reshape(nwin, C, K).permute(2, 0, 1).reshape(K, L)
    flags = _fold_flags(keysT, validT)
    buf, run, prefix = ec_kernels.proj_fold(spec, slabs[0], slabs[1],
                                            slabs[2], flags, K)
    buf = tuple(x.reshape(n, K, nwin, C) for x in buf)
    run = tuple(x.reshape(n, nwin, C).permute(1, 2, 0) for x in run)
    prefix = tuple(x.reshape(n, nwin, C).permute(1, 2, 0) for x in prefix)
    cur_key = keysT[K - 1].reshape(nwin, C)
    st = _level0_tail(spec, keys, buf, run, prefix, first_key, cur_key,
                      B, nwin, K, w_idx, limb_major_buf=True,
                      prev_buckets=buckets)
    return st["keys"], st["vals"], st["buckets"]


def _scatter_set(buckets, w_idx, idx, vals, B: int):
    """buckets[w, idx] = vals where idx < B; idx == B drops the write (the
    JAX package's scatter mode="drop"). Returns new tensors."""
    out = []
    for bc, v in zip(buckets, vals):
        padded = torch.cat([bc, bc[:, :1]], dim=1)  # column B: dropped
        padded[w_idx, idx] = v
        out.append(padded[:, :B])
    return tuple(out)


def _fold_levels_xla(spec: CurveSpec, keys, vals, buckets, B: int,
                     nwin: int):
    """Boundary-stream folding to completion in K-step loops with
    scatter-set bucket writes (G2 from level 1 on; G1's final level)."""
    K = CHUNK_K
    dev = keys.device
    w_idx = torch.arange(nwin, device=dev)[:, None]
    o = spec.ops

    while True:
        keys, vals, C = _pad_entries(keys, vals, B, nwin, K, spec)
        keys3 = keys.reshape(nwin, C, K)
        vals3 = tuple(v.reshape((nwin, C, K) + v.shape[2:]) for v in vals)
        first_key = keys3[:, :, 0]
        inf = ec.proj_point_inf(spec, (nwin, C), device=dev)
        run, cur_key, prefix = inf, first_key, inf
        for t in range(K):
            k = keys3[:, :, t]
            v_pt = tuple(x[:, :, t] for x in vals3)
            v_valid = ~o.is_zero(v_pt[2])
            changed = k != cur_key
            is_first = cur_key == first_key
            prefix = ec.select_point(spec, changed & is_first, run, prefix)
            flush = changed & ~is_first
            widx = torch.where(flush, cur_key, torch.full_like(cur_key, B))
            buckets = _scatter_set(buckets, w_idx, widx, run, B)
            addend = ec.select_point(spec, ~changed & v_valid, v_pt, inf)
            grown = ec.proj_add(spec, run, addend)
            run = ec.select_point(spec, changed, v_pt, grown)
            cur_key = k

        single = cur_key == first_key
        prefix = ec.select_point(spec, single, run, prefix)
        if C == 1:
            # final: write the outermost prefix / suffix partials
            full_b = torch.full_like(first_key, B)
            pidx = torch.where(first_key < B, first_key, full_b)
            buckets = _scatter_set(buckets, w_idx, pidx, prefix, B)
            sidx = torch.where(~single & (cur_key < B), cur_key, full_b)
            return _scatter_set(buckets, w_idx, sidx, run, B)
        suf_key = torch.where(single, first_key, cur_key)
        suffix = ec.select_point(spec, single, inf, run)
        keys = torch.stack([first_key, suf_key], dim=2).reshape(nwin, 2 * C)
        vals = tuple(
            torch.stack([p, s], dim=2).reshape((nwin, 2 * C) + p.shape[2:])
            for p, s in zip(prefix, suffix))


def _suffix_sums(spec: CurveSpec, pts):
    """suffix[i] = sum_{j >= i} pts[j] along axis 1, log-depth shift-adds
    (projective points, identity padding)."""
    width = pts[0].shape[1]
    inf = ec.proj_point_inf(spec, pts[0].shape[:1] + (width,),
                            device=pts[0].device)
    s = 1
    while s < width:
        shifted = tuple(torch.cat([x[:, s:], i[:, :s]], dim=1)
                        for x, i in zip(pts, inf))
        pts = ec.proj_add(spec, pts, shifted)
        s *= 2
    return pts


def _horner_combine(spec: CurveSpec, window_sums, c: int):
    """sum_w 2^(c*w) W_w from the top window down (projective in and
    out)."""
    nwin = window_sums[0].shape[0]
    acc = tuple(x[nwin - 1] for x in window_sums)
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = ec.proj_double(spec, acc)
        acc = ec.proj_add(spec, acc, tuple(x[w] for x in window_sums))
    return acc


def _msm_small(spec: CurveSpec, points, scalars_std):
    """Direct MSM for tiny N: batched double-and-add + log-depth tree
    sum."""
    acc = ec.scalar_mul(spec, points, scalars_std)
    n = points[0].shape[0]
    while n > 1:
        half = (n + 1) // 2
        lo = tuple(x[:half] for x in acc)
        hi = tuple(x[half:2 * half] for x in acc)
        if hi[0].shape[0] < half:
            pad = half - hi[0].shape[0]
            inf = ec.point_inf(spec, (pad,), device=hi[0].device)
            hi = tuple(torch.cat([h, i]) for h, i in zip(hi, inf))
        acc = ec.add(spec, lo, hi)
        n = half
    return tuple(x[0] for x in acc)


def default_window(n: int) -> int:
    """Window width by point count (the JAX package's choice)."""
    if n >= 1 << 19:
        return 15
    if n >= 1 << 16:
        return 13
    if n >= 1 << 13:
        return 10
    return 8


def msm(spec: CurveSpec, points, scalars_std, c: int | None = None,
        chunk: int | None = None):
    """MSM of Jacobian `points` (leading axis N, affine-or-infinity: Z in
    {0, 1}) with standard-form scalar limbs (N, nlimbs). Returns one
    Jacobian point. `chunk` bounds the points per Pippenger pass (G2
    default 2^18); chunks combine with complete adds."""
    with timing.span("msm"):
        N = points[0].shape[0]
        if N <= 64:
            return _msm_small(spec, points, scalars_std)
        if chunk is None and spec.ops.coord_ndim > 1:
            chunk = 1 << 18
        if chunk is not None and N > chunk:
            acc = None
            for lo in range(0, N, chunk):
                part = msm(spec, tuple(x[lo:lo + chunk] for x in points),
                           scalars_std[lo:lo + chunk], c=c, chunk=None)
                acc = part if acc is None else ec.add(spec, acc, part)
            return acc
        if c is None:
            c = default_window(N)
        return _pippenger_signed(spec, points, scalars_std, c)
