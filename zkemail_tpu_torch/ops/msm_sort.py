"""Sort-based multi-scalar multiplication: no bucket table, no scatter.

The port of ``zkemail_tpu/ops/msm_sort.py`` (``msm_sorted``,
``build_signal_plan``, ``msm_sorted_pruned``, ``msm_bitserial``). The first
three are the MSM route of ``prove_batch`` on the card, as the JAX module
is the route of the JAX prover on an accelerator; ``msm_bitserial`` is on
no route (it is slower than the pruned sort MSM on the card, where the JAX
prover took it for G2 only because its Fq2 sort program did not compile).
The algorithm is the same; per (proof, window) row of signed c-bit digits:

  1. sort the digit magnitudes, descending and stable, with the point index
     and the sign as payload;
  2. the weighted sum S = sum_j w_j Q_j over the non-increasing weights
     telescopes through K-element blocks,

         S = sum_blocks (intra-block correction) + sum_i wl_i B_i,

     B_i the block's plain sum and wl_i its last (smallest) weight; the
     second term is the same problem at 1/K the size, already sorted;
  3. the corrections by the threshold identity: for each v in 1..2^(c-1) at
     most one block has wl < v <= wf, and it contributes the prefix sum of
     its elements of weight >= v.

What differs from the JAX module, whose shape was set by the TPU's compile
times, its watchdog and a slow gather inside ``lax.scan``:

  * each K-step scan gathers its step's elements inside the loop (one
    ``index_select``) instead of materialising K scan-major copies;
  * one rows call covers every row of an MSM while its level-1 working set
    fits ``ROWS_CALL_BYTES``, and ``msm_sorted`` slices columns only when
    asked (``col_chunk``); the final level then runs once per MSM;
  * after the sort, the columns past the last nonzero digit of every row of
    a call are dropped (their weight is 0 everywhere);
  * the final level's prefix sums are a log-depth scan, and the threshold
    terms of all levels are summed by one pairwise reduction;
  * the pruned MSM groups rows by their own window prefix;
  * the Horner combination stays on the device for G1 and G2 alike; the
    bit-serial MSM runs its bit rows through the same Horner loop, one
    doubling per bit position.

Every curve addition is K2 (G1) or K3 (G2) through ``core/curve_torch.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as NF

from ..core import curve_torch as CT
from ..core import field as F
from .msm import _first, _horner_combine, concat_points, extract_signed_digits, map_coords

L = F.LIMBS
C_BITS_SORT = 13
K_BLOCK = 16
FINAL_CUTOFF = 256
# Level-1 working set one rows call may take: the gathered step elements,
# the block-sum accumulator and the kernel's output (each R * n / K points),
# and the sort's keys and payload (16 bytes per digit). The full640 h MSM
# (B = 2, 40 rows of 2^21 digits) counts 5.5 GB and is one call.
ROWS_CALL_BYTES = 16 << 30
POINT_BYTES = {"fq": 3 * L * 4, "fq2": 6 * L * 4}


def n_windows_for(c_bits: int) -> int:
    return -(-254 // c_bits)


def _check_scalars(name: str, scalars: torch.Tensor, points: dict) -> tuple[int, int]:
    if scalars.dim() != 3 or scalars.shape[0] != L:
        raise ValueError(
            f"{name} expects scalars shaped (L={L}, B, n); got {tuple(scalars.shape)}"
        )
    _, bsz, n = scalars.shape
    n_points = _first(points).shape[1]
    if n != n_points:
        raise ValueError(
            f"{name}: scalars last axis ({n}) must equal point count ({n_points}); "
            "batch axis goes second"
        )
    return bsz, n


def _cols(points: dict, s0: int, s1: int) -> dict:
    return map_coords(points, lambda c: c[:, s0:s1])


def _take(points: dict, idx: torch.Tensor) -> dict:
    """points (n,) gathered at an index tensor -> batch idx.shape."""
    flat = idx.reshape(-1)
    return map_coords(points, lambda c: c.index_select(1, flat).view((L,) + tuple(idx.shape)))


def _identity(ops, shape, device) -> dict:
    return map_coords(CT.ec_identity(ops, shape, device), lambda c: c.contiguous())


def _stack_last(pts: list) -> dict:
    out = {}
    for k, v in pts[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.stack([p[k][i] for p in pts], dim=-1) for i in range(len(v)))
        else:
            out[k] = torch.stack([p[k] for p in pts], dim=-1)
    return out


def _put(pt: dict, idx: torch.Tensor, part: dict) -> dict:
    """pt with its batch positions idx (along the last batch axis of an
    (L, m) batch) replaced by part (L, len(idx))."""
    out = {}
    for k, v in pt.items():
        if isinstance(v, tuple):
            out[k] = tuple(a.index_copy(1, idx, b) for a, b in zip(v, part[k]))
        else:
            out[k] = v.index_copy(1, idx, part[k])
    return out


def _digit_rows(scalars: torch.Tensor, c_bits: int):
    """(L, B, n) standard scalars -> signed digit rows (B * n_windows, n):
    row b * n_windows + j holds window j of batch element b."""
    _, bsz, n = scalars.shape
    nw = n_windows_for(c_bits)
    mag, neg = extract_signed_digits(scalars.reshape(L, bsz * n), c_bits, nw)

    def rows(d):
        return d.view(nw, bsz, n).transpose(0, 1).reshape(bsz * nw, n)

    return rows(mag), rows(neg)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _ec_sum_last(ops, pts: dict) -> dict:
    """Sum a point batch over its last batch axis by pairwise halving:
    log2(m) additions, each one launch over all lanes."""
    m = _first(pts).shape[-1]
    while m > 1:
        half = m // 2
        s = CT.ec_add(ops, map_coords(pts, lambda c: c[..., :half]),
                      map_coords(pts, lambda c: c[..., half : 2 * half]))
        if m % 2:
            rest = map_coords(pts, lambda c: c[..., 2 * half : m])
            s = concat_points([s, rest], dim=_first(s).dim() - 2)
            m = half + 1
        else:
            m = half
        pts = s
    return map_coords(pts, lambda c: c[..., 0])


def _scan_sum(ops, elem, steps: int, shape, device, outputs: bool = False) -> dict:
    """Accumulate `steps` point batches of batch `shape`: elem(k) returns the
    k-th (point, neg) pair, neg an int tensor (a nonzero lane adds the
    negated point, inside the kernel) or None. The step's elements are
    gathered inside the loop. outputs=True returns the inclusive prefixes
    stacked on a new last axis, else the total."""
    acc = _identity(ops, shape, device)
    outs = []
    for k in range(steps):
        e, ng = elem(k)
        acc = CT.ec_add(ops, acc, e) if ng is None else CT.ec_add_signed(ops, acc, e, ng)
        if outputs:
            outs.append(acc)
    return _stack_last(outs) if outputs else acc


def _prefix_scan(ops, pts: dict) -> dict:
    """Inclusive prefix sums over the last batch axis, log-depth
    (Hillis-Steele): step d adds element i - d into element i >= d."""
    m = _first(pts).shape[-1]
    axis = _first(pts).dim() - 2
    d = 1
    while d < m:
        head = map_coords(pts, lambda c: c[..., :d])
        tail = CT.ec_add(ops, map_coords(pts, lambda c: c[..., d:]),
                         map_coords(pts, lambda c: c[..., : m - d]))
        pts = concat_points([head, tail], dim=axis)
        d *= 2
    return pts


# ---------------------------------------------------------------------------
# the telescope
# ---------------------------------------------------------------------------

def _count_at_least(w_desc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per row, how many entries of a non-increasing row are >= each v:
    w_desc (R, m), v (nb,) -> (R, nb) int64."""
    rows = w_desc.shape[0]
    asc = w_desc.flip(1).contiguous()
    vals = v.expand(rows, v.numel()).contiguous()
    return w_desc.shape[1] - torch.searchsorted(asc, vals, side="left")


def _correction(ops, src, wq, wf, wl, nb: int, K: int) -> dict:
    """Threshold terms of one telescoping level: for each v in 1..nb the
    intra-block prefix at v's boundary block (the one with wl < v <= wf),
    or the identity. Returns a point batch (R, nb), summed by the caller.

    src: ("lazy", points, si, sn) gathers block elements from the shared
    points (level 1); ("mat", pr) reads a materialised (L, R, nblk, K)
    batch (later levels). wq: weights (R, nblk, K)."""
    R, nblk, _ = wq.shape
    dev = wq.device
    nbb = min(nb, nblk)
    flag = wf != wl
    # stable partition: boundary blocks first, ascending, so the compacted
    # slots keep the global descending weight order
    order = torch.sort((~flag).to(torch.int32), dim=1, stable=True).indices[:, :nbb]
    blk = order[:, :, None].expand(R, nbb, K)
    bw = torch.gather(wq, 1, blk)
    if src[0] == "lazy":
        _, points, si, sn = src
        bi, bn = torch.gather(si, 1, blk), torch.gather(sn, 1, blk)
        ips = _scan_sum(ops, lambda k: (_take(points, bi[:, :, k]), bn[:, :, k]),
                        K, (R, nbb), dev, outputs=True)
    else:
        pr = src[1]
        idx = order[None, :, :, None].expand(L, R, nbb, K)
        bpts = map_coords(pr, lambda c: torch.gather(c, 2, idx))
        ips = _scan_sum(ops, lambda k: (map_coords(bpts, lambda c: c[..., k]), None),
                        K, (R, nbb), dev, outputs=True)
    ips = map_coords(ips, lambda c: c.reshape(L, R, nbb * K))

    fl_c = torch.gather(flag, 1, order)
    wf_c = torch.where(fl_c, torch.gather(wf, 1, order), -1)
    wl_c = torch.where(fl_c, torch.gather(wl, 1, order), -1)
    v = torch.arange(1, nb + 1, dtype=wq.dtype, device=dev)
    # the block with wl < v <= wf is the last slot with wf >= v (slots are
    # descending in wf, padding pinned to -1 at the tail), if its wl < v
    cnt = _count_at_least(wf_c, v)
    s_v = (cnt - 1).clamp_min(0)
    wl_s = torch.gather(wl_c, 1, s_v)
    wf_s = torch.gather(wf_c, 1, s_v)
    valid = (cnt > 0) & (wl_s < v) & (v <= wf_s)
    bw_s = torch.gather(bw, 1, s_v[:, :, None].expand(R, nb, K))
    c_v = (bw_s >= v[None, :, None]).sum(2)
    flat = s_v * K + (c_v - 1).clamp_min(0)
    q = map_coords(ips, lambda c: torch.gather(c, 2, flat[None].expand(L, R, nb)))
    return CT.ec_select(ops, ~valid, _identity(ops, (R, nb), dev), q)


def _final_level(ops, pts: dict, w: torch.Tensor, nb: int) -> dict:
    """Threshold terms over the last few elements: for each v the prefix sum
    of the elements of weight >= v. pts (R, m), w (R, m) non-increasing.
    Returns (R, nb) points, summed by the caller."""
    R, _ = w.shape
    psf = _prefix_scan(ops, pts)
    v = torch.arange(1, nb + 1, dtype=w.dtype, device=w.device)
    cnt = _count_at_least(w, v)
    idx = (cnt - 1).clamp_min(0)
    q = map_coords(psf, lambda c: torch.gather(c, 2, idx[None].expand(L, R, nb)))
    return CT.ec_select(ops, cnt == 0, _identity(ops, (R, nb), w.device), q)


def _rows(ops, points: dict, mag: torch.Tensor, neg: torch.Tensor, K: int,
          cutoff: int, nb: int) -> dict:
    """One rows call: points (n,), digit rows mag/neg (R, n) -> the rows'
    weighted sums, a point batch (R,)."""
    R = mag.shape[0]
    dev = mag.device
    w, sidx = torch.sort(mag, dim=1, descending=True, stable=True)
    live = int((w != 0).sum(dim=1).max())
    if live == 0:  # a column slice may hold no nonzero digit
        return _identity(ops, (R,), dev)
    # weight-0 columns never enter a threshold prefix: drop those past the
    # last nonzero digit of every row, pad to a multiple of K with weight 0
    m = -(-live // K) * K
    w, sidx = w[:, :live].to(torch.int32), sidx[:, :live]
    sneg = torch.gather(neg, 1, sidx).to(torch.int32)
    if m != live:
        w, sidx, sneg = (NF.pad(t, (0, m - live)) for t in (w, sidx, sneg))

    # each level's threshold terms stop at its largest weight: no block or
    # element reaches a larger v
    terms = []
    vmax = int(w[:, 0].max())
    nblk = m // K
    si, sn, wq = sidx.view(R, nblk, K), sneg.view(R, nblk, K), w.view(R, nblk, K)
    pts = _scan_sum(ops, lambda k: (_take(points, si[:, :, k]), sn[:, :, k]),
                    K, (R, nblk), dev)
    wl = wq[:, :, K - 1]
    terms.append(_correction(ops, ("lazy", points, si, sn), wq, wq[:, :, 0], wl,
                             min(nb, vmax), K))
    w, m = wl, nblk
    while m > cutoff:
        vmax = int(w[:, 0].max())
        if vmax == 0:
            break
        nblk = -(-m // K)
        if nblk * K != m:
            pad = nblk * K - m
            w = NF.pad(w, (0, pad))
            pts = concat_points([pts, _identity(ops, (R, pad), dev)], dim=1)
        pr = map_coords(pts, lambda c: c.reshape(L, R, nblk, K))
        pts = _scan_sum(ops, lambda k: (map_coords(pr, lambda c: c[..., k]), None),
                        K, (R, nblk), dev)
        wq = w.reshape(R, nblk, K)
        wl = wq[:, :, K - 1]
        terms.append(_correction(ops, ("mat", pr), wq, wq[:, :, 0], wl, min(nb, vmax), K))
        w, m = wl, nblk
    vmax = int(w[:, 0].max())
    if vmax:
        terms.append(_final_level(ops, pts, w, min(nb, vmax)))
    return _ec_sum_last(ops, concat_points(terms, dim=1))


def _rows_per_call(ops, n: int, K: int) -> int:
    per_row = 3 * POINT_BYTES[ops.name] * -(-n // K) + 16 * n
    return max(1, ROWS_CALL_BYTES // per_row)


def _rows_sum(ops, points: dict, mag: torch.Tensor, neg: torch.Tensor, K: int,
              cutoff: int, nb: int, col_chunk: int = 0) -> dict:
    """Weighted sums of digit rows (rows, n) over points (n,) -> (rows,).
    Rows without a nonzero digit are the identity and take no call; the
    others go in calls of as many rows as ROWS_CALL_BYTES allows and, when
    0 < col_chunk < n, over column slices summed."""
    n_rows, n = mag.shape
    total = _identity(ops, (n_rows,), mag.device)
    live = torch.nonzero((mag != 0).any(dim=1)).flatten()
    if live.numel() == 0:
        return total
    mag, neg = mag[live], neg[live]
    R = _rows_per_call(ops, n, K)
    W = col_chunk if 0 < col_chunk < n else n
    parts = []
    for r0 in range(0, live.numel(), R):
        acc = None
        for s0 in range(0, n, W):
            out = _rows(ops, _cols(points, s0, s0 + W), mag[r0 : r0 + R, s0 : s0 + W],
                        neg[r0 : r0 + R, s0 : s0 + W], K, cutoff, nb)
            acc = out if acc is None else CT.ec_add(ops, acc, out)
        parts.append(acc)
    return _put(total, live, concat_points(parts, dim=0))


def msm_sorted(ops, points: dict, scalars: torch.Tensor, c_bits: int = C_BITS_SORT,
               k_block: int = K_BLOCK, cutoff: int = 0, col_chunk: int = 0,
               tail: bool = True) -> dict:
    """Batched MSM with shared bases through the sort/telescope pipeline.

    The contract of ops.msm.msm_multi: scalars (L, B, n) standard-form Fr
    limbs, points a projective batch (n,); returns the point batch (B,),
    or with tail=False the per-window sums (B, n_windows) before the Horner
    combination (window j weighs 2^(c j)). col_chunk: column slice width, 0
    for none (exact: disjoint column subsets sum to the same group
    element); cutoff: the width at which the telescope stops (0:
    min(2^(c-1), 256)).

    The JAX package's traced twin (``msm_sorted_traced``, for ``shard_map``
    bodies) has no counterpart: this function runs eagerly on each rank of
    a mesh (``parallel/sharding.py::sharded_sort_msm``)."""
    bsz, _ = _check_scalars("msm_sorted", scalars, points)
    nw = n_windows_for(c_bits)
    nb = 1 << (c_bits - 1)
    mag, neg = _digit_rows(scalars, c_bits)
    total = _rows_sum(ops, points, mag, neg, k_block, cutoff or min(nb, FINAL_CUTOFF),
                      nb, col_chunk)
    total = map_coords(total, lambda c: c.reshape(L, bsz, nw))
    return _horner_combine(ops, total, nw, c_bits) if tail else total


# ---------------------------------------------------------------------------
# window pruning: the signal plan
# ---------------------------------------------------------------------------
#
# A witness is sparse in the digit domain: most signals of a byte- and
# bit-heavy circuit have at most 12 bits, so at c = 13 their digits in
# windows 1.. are all zero. Ordering the signals by how many windows they
# populate lets window j stop at a prefix of the signal axis. The plan is a
# hint, never trusted: every call checks the batch's digits against it on
# the device and returns None on a miss, and the caller proves dense.


def build_signal_plan(scalars: torch.Tensor, c_bits: int = C_BITS_SORT):
    """Signal plan from one batch of witness scalars (L, B, n), on their
    device.

    Returns (perm, prefixes): perm (n,) int64 orders the signals by
    descending populated-window count (stable); prefixes[j] is how many
    permuted signals have a nonzero digit at window j in some batch element
    (a prefix, by construction). Permute the bases by perm once, and pass
    the same plan with the unpermuted scalars of every later call."""
    _, bsz, n = scalars.shape
    nw = n_windows_for(c_bits)
    mag, _ = extract_signed_digits(scalars.reshape(L, bsz * n), c_bits, nw)
    wid = torch.arange(1, nw + 1, dtype=torch.int64, device=scalars.device)
    wins = torch.where(mag.view(nw, bsz, n) != 0, wid[:, None, None], 0).amax(dim=(0, 1))
    perm = torch.sort(wins, descending=True, stable=True).indices
    counts = torch.bincount(wins, minlength=nw + 1)
    prefixes = counts.flip(0).cumsum(0).flip(0)[1:]  # signals with wins > j
    return perm, tuple(int(p) for p in prefixes.tolist())


def _plan_digit_rows(scalars: torch.Tensor, perm, prefixes: tuple, c_bits: int):
    """Digit rows of the permuted scalars, or None when a nonzero digit lies
    at or past its window's prefix (the plan does not cover the batch)."""
    nw = n_windows_for(c_bits)
    if len(prefixes) != nw:
        raise ValueError(f"plan has {len(prefixes)} windows; c_bits={c_bits} needs {nw}")
    dev = scalars.device
    perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    mag, neg = _digit_rows(scalars.index_select(2, perm), c_bits)
    n_rows, n = mag.shape
    bound = torch.tensor(prefixes, dtype=torch.int64, device=dev).repeat(n_rows // nw)
    beyond = torch.arange(n, device=dev)[None, :] >= bound[:, None]
    if bool((beyond & (mag != 0)).any()):
        return None
    return mag, neg


def _width_groups(widths: list) -> list:
    """Indices grouped for shared calls by their widths: widest first, and
    a group takes every index down to 7/8 of its own width (the extra
    columns of its narrower members hold zero digits). Width 0 is left out.
    Returns [(width, [indices])]."""
    groups = []
    for i in sorted((i for i, w in enumerate(widths) if w), key=lambda i: -widths[i]):
        if groups and 8 * widths[i] >= 7 * groups[-1][0]:
            groups[-1][1].append(i)
        else:
            groups.append((widths[i], [i]))
    return groups


def msm_sorted_pruned(ops, points: dict, scalars: torch.Tensor, perm, prefixes: tuple,
                      c_bits: int = C_BITS_SORT, k_block: int = K_BLOCK,
                      cutoff: int = 0):
    """Window-pruned batched MSM over signal-permuted bases.

    `points` are the bases permuted by `perm` (permute once, keep); the
    scalars (L, B, n) are unpermuted. Each row (batch element, window j)
    runs over the first prefixes[j] permuted signals only, in calls that
    group rows of like width. The result equals msm_sorted(unpermuted
    points, scalars); None when the batch's digits exceed the plan."""
    bsz, _ = _check_scalars("msm_sorted_pruned", scalars, points)
    rows = _plan_digit_rows(scalars, perm, prefixes, c_bits)
    if rows is None:
        return None
    mag, neg = rows
    nw = n_windows_for(c_bits)
    nb = 1 << (c_bits - 1)
    dev = scalars.device
    total = _identity(ops, (bsz * nw,), dev)
    for width, idx in _width_groups([prefixes[r % nw] for r in range(bsz * nw)]):
        idx = torch.tensor(idx, dtype=torch.int64, device=dev)
        part = _rows_sum(ops, _cols(points, 0, width), mag[idx, :width], neg[idx, :width],
                         k_block, cutoff or min(nb, FINAL_CUTOFF), nb)
        total = _put(total, idx, part)
    total = map_coords(total, lambda c: c.reshape(L, bsz, nw))
    return _horner_combine(ops, total, nw, c_bits)


# ---------------------------------------------------------------------------
# bit-serial MSM
# ---------------------------------------------------------------------------
#
# S = sum_b 2^b sum_{i: bit b of |d_i| set} (+-Q_i): each inner sum is a
# masked signed scan over the points in their natural order, with no sort
# and no threshold terms, at c_bits / (1 + 1/K) times the sort route's
# additions. Bit t of window j has weight 2^(c j + t), so the bit rows of
# every window go through one Horner loop with one doubling per bit.


def _bits_block(ops, points: dict, mask: torch.Tensor, negs: torch.Tensor, K: int) -> dict:
    """Masked signed sums of bit rows (R, w) over points (w,) -> (R,). The
    width is padded to a multiple of K with identity points and zero bits."""
    R, w = mask.shape
    m = -(-w // K) * K
    if m != w:
        points = concat_points([points, _identity(ops, (m - w,), mask.device)], dim=0)
        mask, negs = NF.pad(mask, (0, m - w)), NF.pad(negs, (0, m - w))
    nblk = m // K
    acc = _identity(ops, (R, nblk), mask.device)
    for k in range(K):
        e = map_coords(points, lambda c: c[:, None, k::K])
        added = CT.ec_add_signed(ops, acc, e, negs[:, k::K])
        acc = CT.ec_select(ops, mask[:, k::K] == 0, acc, added)
    return _ec_sum_last(ops, acc)


def msm_bitserial(ops, points: dict, scalars: torch.Tensor, perm=None,
                  prefixes: tuple | None = None, c_bits: int = C_BITS_SORT,
                  k_block: int = K_BLOCK):
    """Bit-serial masked-scan MSM, the contract and result of msm_sorted.

    With a plan (perm, prefixes) from build_signal_plan, `points` are the
    permuted bases and window j's bit rows stop at prefixes[j]; returns None
    on a plan miss. Any width is accepted: it is padded to a multiple of
    k_block."""
    bsz, n = _check_scalars("msm_bitserial", scalars, points)
    nw = n_windows_for(c_bits)
    if prefixes is None:
        mag, neg = _digit_rows(scalars, c_bits)
        widths = [n] * nw
    else:
        rows = _plan_digit_rows(scalars, perm, prefixes, c_bits)
        if rows is None:
            return None
        mag, neg = rows
        widths = list(prefixes)
    dev = scalars.device
    mag, neg = mag.view(bsz, nw, n).to(torch.int32), neg.view(bsz, nw, n).to(torch.int32)
    bit = torch.arange(c_bits, dtype=torch.int32, device=dev)
    n_pos = nw * c_bits  # bit position j * c_bits + t, per batch element
    total = _identity(ops, (bsz * n_pos,), dev)
    for width, wins in _width_groups(widths):
        wi = torch.tensor(wins, dtype=torch.int64, device=dev)
        m = mag.index_select(1, wi)[:, :, None, :width]  # (B, nw', 1, width)
        mask = ((m >> bit[None, None, :, None]) & 1).reshape(-1, width)
        negs = neg.index_select(1, wi)[:, :, None, :width].expand(m.shape[:2] + (c_bits, width))
        negs = negs.reshape(-1, width)
        part = _bits_block(ops, _cols(points, 0, width), mask, negs, k_block)
        pos = (torch.arange(bsz, device=dev)[:, None, None] * n_pos
               + wi[None, :, None] * c_bits + bit.long()[None, None, :])
        total = _put(total, pos.reshape(-1), part)
    total = map_coords(total, lambda c: c.reshape(L, bsz, n_pos))
    return _horner_combine(ops, total, n_pos, 1)
