"""Sparse-grid index machinery (counterpart of robustpointclouds_tpu/ops/sparse.py).

Two uses:
  * the structure builders of the inline (plan=None) path — the batch
    merge (`with_batch_axis`), submanifold neighbour relations
    (`neighbor_index`, `neighbor_xwin_info`), strided downsample sites with
    their forward and inverse indices (`downsample_with_index`,
    `xwin_from_index`) — in torch ops on the coordinates' device. Their
    outputs are bit-equal to the JAX builders' and to the native host
    plan's (data/native_plan.py), padding rows and INT32_MAX ids included.
    JAX ranks queries by one packed key sort, because per-query binary
    search is slow on the TPU; here the same left insertion rank, exact hit
    and clamped successor delta come from `torch.searchsorted` on the
    sorted ids. Every scatter goes through :func:`scatter_set`: dropped
    items go to one scratch row that is sliced away, and no other target
    repeats, so no output depends on which duplicate a scatter keeps. The
    JAX package's merge-path rank variant (RPC_MP_RANKS, off by default)
    replaces its packed-key sort by a compare-reduce to the same ranks;
    `searchsorted` gives them too, and tests/test_torch_k1_variants.py holds
    the inline encoder plan bit-equal to JAX's with the flag on.
  * the conversions of the plan-fed path. The plan carries every neighbour
    relation of the encoder in one of three layouts, fixed per level as
    the native plan keeps them (data/native_plan.py): x-window
    `rows`/`xvalid`, a dense `[M, 27]` index, and the inverse index `inv`
    of every strided downsample. On the GPU one gather-GEMM kernel (kernels/sparse_conv.py)
    serves all convs, so each layout becomes the dense forward index
    `idx [M, K]`: tap order of :func:`kernel_offsets`, miss = the input row
    count N (which reads a zero row).
  * the densification of sparse rows into a dense grid: a scatter
    (:func:`scatter_to_dense`) on every path. The JAX package gathers
    through a plan-carried cell -> row map instead (its plan-fed
    PointPillars by default, SECOND's encoder with RPC_DENSE_GATHER),
    because the TPU serialises scatters. The two agree bit for bit
    (tests/test_torch_pointpillars.py and tests/test_torch_dense_gather.py
    hold the scatter to JAX's gather form), and on the H100 the gather form
    is the slower one (chip_smoke.py phase 16 (b)), so the port scatters.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.device import device_constant

INT32_MAX = np.iinfo(np.int32).max
# JAX's wide two-key rank sort needs ids below this band: past it the
# neighbour index takes the one-query-per-tap form, as in JAX
_WIDE_BAND = INT32_MAX - (1 << 26)


class SparseGrid(NamedTuple):
    """Active sites sorted by flat id (padding: id INT32_MAX, coords -1, mask False)."""

    flat_ids: torch.Tensor  # [N] int32
    coords: torch.Tensor    # [N, ndim] int32
    mask: torch.Tensor      # [N] bool
    spatial_shape: Tuple[int, ...]


class XWindowInfo(NamedTuple):
    """x-window form of a neighbour relation: `rows[i, g]` = p*kx + d0 names
    the window of kx ids starting at ids[p] - d0 (miss = n_in*kx); `xvalid`
    masks taps whose x coordinate leaves [0, W)."""

    rows: torch.Tensor    # [N, G] int32 in [0, n_in*kx]
    xvalid: torch.Tensor  # [N, kx] bool
    kx: int
    n_in: int


def _strides_of(shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major flattening strides of a shape (the flat id space fits int32)."""
    s = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        s[i] = s[i + 1] * int(shape[i + 1])
    assert s[0] * int(shape[0]) <= INT32_MAX, "flat id space exceeds int32"
    return tuple(s)


def _id_space(shape: Sequence[int]) -> int:
    return int(np.prod([int(s) for s in shape], dtype=np.int64))


def scatter_set(size: int, index: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """`out[index] = values` over `size` rows filled with `fill`; index
    `size` is the scratch row, dropped from the result. Callers send every
    dropped item there and no other target twice, so the result does not
    depend on which of a repeated target's values a scatter keeps (CUDA's
    `index_put_` does not say). `values` has the index's shape plus the
    rows' trailing dims."""
    trail = tuple(values.shape[index.dim():])
    out = torch.full((size + 1,) + trail, fill, dtype=values.dtype, device=values.device)
    out.index_put_((index.reshape(-1).long(),), values.reshape((-1,) + trail))
    return out[:size]


def kernel_offsets(kernel_size: Sequence[int]) -> np.ndarray:
    """All taps of an N-D kernel, row-major. [K, ndim] int32 (static)."""
    grids = np.meshgrid(*[np.arange(k) for k in kernel_size], indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


# -- the structure builders of the inline path ---------------------------------

def flatten_coords(coords: torch.Tensor, mask: torch.Tensor, spatial_shape) -> torch.Tensor:
    """Flat row-major ids [N] int32; INT32_MAX where `mask` is False."""
    strides = device_constant(_strides_of(spatial_shape), torch.int64, coords.device)
    flat = (coords.long() * strides).sum(-1)
    return torch.where(mask, flat, torch.full_like(flat, INT32_MAX)).to(torch.int32)


def with_batch_axis(coords: torch.Tensor, mask: torch.Tensor, spatial_shape
                    ) -> Tuple[SparseGrid, torch.Tensor]:
    """Merge per-sample sparse sets [B, V, D] into one (1 + D)-dim SparseGrid.

    Padding rows carry the INT32_MAX id, so the batch-major concatenation is
    not sorted; one stable argsort over [B*V] sorts it (the padding rows
    keep their batch-major order). Returns (grid, order int32): `order`
    indexes the flattened [B*V] rows, `feats.reshape(B*V, C)[order]`
    aligns per-voxel features with the grid. The merged ids must fit int32:
    past 2^31 this raises (shard the batch instead).
    """
    b, v = coords.shape[:2]
    id_space = b * _id_space(spatial_shape)
    if id_space >= 1 << 31:
        per = _id_space(spatial_shape)
        raise ValueError(
            f"merged flat-id space B*prod(sparse_shape) = {b}*{per} = {id_space} overflows "
            f"int32 (max batch here: {((1 << 31) - 1) // per}). Shard the batch over "
            "devices (per-device sub-plans) instead of growing the per-device batch.")
    dev = coords.device
    bcol = torch.arange(b, dtype=torch.int32, device=dev)[:, None, None].expand(b, v, 1)
    coords4 = torch.cat([bcol, coords.to(torch.int32)], -1).reshape(b * v, coords.shape[-1] + 1)
    mask_flat = mask.reshape(b * v)
    coords4 = torch.where(mask_flat[:, None], coords4, torch.full_like(coords4, -1))
    shape4 = (b,) + tuple(int(s) for s in spatial_shape)
    flat = flatten_coords(coords4, mask_flat, shape4)
    order = torch.argsort(flat, stable=True)
    grid = SparseGrid(flat[order], coords4[order], mask_flat[order], shape4)
    return grid, order.to(torch.int32)


def _rank(sorted_ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Left insertion rank [M] int64 of each query in the sorted ids (padding
    INT32_MAX sorts last, so an INT32_MAX query ranks after every real id)."""
    return torch.searchsorted(sorted_ids.long().contiguous(), q.long().contiguous(), side="left")


def _rank_and_hit(sorted_ids: torch.Tensor, q: torch.Tensor):
    """(left insertion rank, exact hit) of each query; JAX's packed / wide
    rank sort computes the same for every query its callers read."""
    n = sorted_ids.shape[0]
    rank = _rank(sorted_ids, q)
    hit = (rank < n) & (sorted_ids.long()[torch.clamp(rank, max=n - 1)] == q.long())
    return rank, hit


def _rank_and_succ_delta(sorted_ids: torch.Tensor, q: torch.Tensor, dmax: int):
    """(left insertion rank, min(ids[rank] - q, dmax)) of each query; past
    the last id the successor is INT32_MAX (so a valid query gets dmax and an
    INT32_MAX query 0, as JAX's clamped sentinels give)."""
    rank = _rank(sorted_ids, q)
    ids_ext = torch.cat([sorted_ids.long(),
                         torch.full((1,), INT32_MAX, dtype=torch.int64, device=q.device)])
    d0 = torch.clamp(ids_ext[rank] - q.long(), 0, dmax)
    return rank, d0


def lookup(grid: SparseGrid, query_flat: torch.Tensor) -> torch.Tensor:
    """Row of each query flat id in the grid; misses and INT32_MAX queries ->
    N. Returns int32 in [0, N], the query's shape."""
    n = grid.flat_ids.shape[0]
    q = query_flat.reshape(-1).long()
    j, hit = _rank_and_hit(grid.flat_ids, q)
    hit = hit & (q != INT32_MAX)
    return torch.where(hit, torch.clamp(j, 0, n - 1), torch.full_like(j, n)).to(
        torch.int32).reshape(query_flat.shape)


def _tap_base(out_coords, stride, padding, ndim):
    return [out_coords[:, a].long() * int(stride[a]) - int(padding[a]) for a in range(ndim)]


def _neighbor_index_dense(in_grid, out_coords, out_mask, offsets, stride, padding):
    """One lookup query per tap."""
    ndim = len(in_grid.spatial_shape)
    in_shape = in_grid.spatial_shape
    strides = _strides_of(in_shape)
    offsets = np.asarray(offsets)
    base = _tap_base(out_coords, stride, padding, ndim)
    cols = []
    for k in range(offsets.shape[0]):
        flat = torch.zeros_like(base[0])
        valid = out_mask
        for a in range(ndim):
            q = base[a] + int(offsets[k, a])
            valid = valid & (q >= 0) & (q < in_shape[a])
            flat = flat + q * strides[a]
        cols.append(torch.where(valid, flat, torch.full_like(flat, INT32_MAX)))
    return lookup(in_grid, torch.stack(cols, 1))


def _neighbor_index_windowed(in_grid, out_coords, out_mask, kernel_size, stride, padding):
    """One rank query per tap group of the leading axes; the kx consecutive
    last-axis taps are read from the id window ids[p .. p+kx-1] at the
    group's rank p (ids between are consecutive integers, so target q0+dx
    sits at p + #present{q0 .. q0+dx-1})."""
    ndim = len(in_grid.spatial_shape)
    kx = int(kernel_size[-1])
    in_shape = in_grid.spatial_shape
    strides = _strides_of(in_shape)
    ids = in_grid.flat_ids
    n = ids.shape[0]
    group_offs = kernel_offsets(kernel_size[:-1])
    g_count = group_offs.shape[0]
    base = _tap_base(out_coords, stride, padding, ndim)
    last = base[ndim - 1]
    q0_cols = []
    for g in range(g_count):
        flat = last
        valid = out_mask
        for a in range(ndim - 1):
            q = base[a] + int(group_offs[g, a])
            valid = valid & (q >= 0) & (q < in_shape[a])
            flat = flat + q * strides[a]
        q0_cols.append(torch.where(valid, flat, torch.full_like(flat, INT32_MAX)))
    q0 = torch.stack(q0_cols, 1)                                   # [N, G] int64
    p = _rank(ids, q0.reshape(-1)).reshape(q0.shape)               # [N, G] in [0, n]
    ids_pad = torch.cat([ids.long(), torch.full((kx,), INT32_MAX, dtype=torch.int64,
                                                device=ids.device)])
    idw = torch.stack([ids_pad[p + d] for d in range(kx)], -1)     # [N, G, kx]
    q0_valid = q0 != INT32_MAX
    out_cols = []
    pos = p
    prev_present = None
    for dx in range(kx):
        target = q0 + dx
        if dx > 0:
            # ranks count values: an out-of-bounds x aliases the next row's
            # ids numerically, bounds filter only the hit
            pos = pos + prev_present.long()
        present = (idw == target[..., None]).any(-1) & q0_valid
        lx = (last + dx)[:, None]
        hit = present & (lx >= 0) & (lx < in_shape[ndim - 1])
        out_cols.append(torch.where(hit, torch.clamp(pos, max=n - 1), torch.full_like(pos, n)))
        prev_present = present
    # tap order: groups major, dx minor == kernel_offsets order
    return torch.stack(out_cols, 2).reshape(q0.shape[0], g_count * kx).to(torch.int32)


def neighbor_index(in_grid: SparseGrid, out_coords: torch.Tensor, out_mask: torch.Tensor,
                   offsets_or_kernel, stride: Sequence[int] = None,
                   padding: Sequence[int] = None) -> torch.Tensor:
    """Per output site, the input row of each kernel tap; misses -> N_in.

    Tap k of output site o reads input coordinate o*stride - padding +
    offset_k. A kernel_size tuple takes the windowed form when the last
    axis has more than one tap (and the id space is below JAX's wide band),
    an explicit [K, ndim] offsets array the one-query-per-tap form; both
    give the same index. Returns [N_out, K] int32 in [0, N_in].
    """
    ndim = len(in_grid.spatial_shape)
    stride = (1,) * ndim if stride is None else stride
    padding = (1,) * ndim if padding is None else padding
    arr = np.asarray(offsets_or_kernel)
    if arr.ndim == 1:
        kernel_size = tuple(int(v) for v in arr)
        if kernel_size[-1] > 1 and _id_space(in_grid.spatial_shape) < _WIDE_BAND:
            return _neighbor_index_windowed(in_grid, out_coords, out_mask, kernel_size,
                                            stride, padding)
        arr = kernel_offsets(kernel_size)
    return _neighbor_index_dense(in_grid, out_coords, out_mask, arr, stride, padding)


def neighbor_xwin_info(in_grid: SparseGrid, out_coords: torch.Tensor, out_mask: torch.Tensor,
                       kernel_size: Sequence[int], stride: Sequence[int] = None,
                       padding: Sequence[int] = None) -> XWindowInfo:
    """The relation in x-window form: per (site, leading-axes tap group) the
    rank p of the group's base id q0 and the distance d0 to the next present
    id (clamped to kx); a hit when d0 < kx."""
    ndim = len(in_grid.spatial_shape)
    stride = (1,) * ndim if stride is None else stride
    padding = (1,) * ndim if padding is None else padding
    kernel_size = tuple(int(v) for v in kernel_size)
    kx = kernel_size[-1]
    in_shape = in_grid.spatial_shape
    strides = _strides_of(in_shape)
    n = in_grid.flat_ids.shape[0]
    group_offs = kernel_offsets(kernel_size[:-1])
    base = _tap_base(out_coords, stride, padding, ndim)
    last = base[ndim - 1]
    q0_cols, valid_cols = [], []
    for g in range(group_offs.shape[0]):
        flat = last
        valid = out_mask
        for a in range(ndim - 1):
            q = base[a] + int(group_offs[g, a])
            valid = valid & (q >= 0) & (q < in_shape[a])
            flat = flat + q * strides[a]
        valid_cols.append(valid)
        q0_cols.append(torch.where(valid, flat, torch.full_like(flat, INT32_MAX)))
    q0 = torch.stack(q0_cols, 1)
    q0_valid = torch.stack(valid_cols, 1)
    p, d0 = _rank_and_succ_delta(in_grid.flat_ids, q0.reshape(-1), kx)
    p, d0 = p.reshape(q0.shape), d0.reshape(q0.shape)
    hit = q0_valid & (d0 < kx) & (p < n)
    rows = torch.where(hit, p * kx + d0, torch.full_like(p, n * kx)).to(torch.int32)
    # x bounds per tap, shared by the groups (not masked by out_mask, as in JAX)
    lx = last[:, None] + torch.arange(kx, dtype=torch.int64, device=last.device)
    xvalid = (lx >= 0) & (lx < in_shape[ndim - 1])
    return XWindowInfo(rows, xvalid, kx, n)


def inverse_from_forward(idx: torch.Tensor, n_in: int) -> torch.Tensor:
    """Transpose of a strided conv's neighbour index.

    idx [N_out, K] holds, per output row and tap, the input row it reads
    (miss = n_in). An input row is read by at most one output row per tap, so
    inv[i, k] = o where idx[o, k] == i is collision-free; misses land in the
    scratch row. Returns [n_in, K] int32 in [0, N_out]. The same function
    maps the plan's inverse index back to the forward one (it is its own
    transpose): `inverse_from_forward(inv, n_out)`.
    """
    n_out, k = idx.shape
    dev = idx.device
    idx = idx.long()
    o = torch.arange(n_out, dtype=torch.int32, device=dev)[:, None].expand(n_out, k)
    flat_pos = idx * k + torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    flat_pos = torch.where(idx < n_in, flat_pos, torch.full_like(flat_pos, n_in * k))
    return scatter_set(n_in * k, flat_pos, o, n_out).reshape(n_in, k)


def _unique_sorted(s: torch.Tensor, cap: int):
    """(unique ids [cap], count, each element's unique rank) of sorted ids."""
    is_first = torch.ones_like(s, dtype=torch.bool)
    is_first[1:] = s[1:] != s[:-1]
    is_first &= s != INT32_MAX
    rank = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = is_first & (rank < cap)
    uniq = scatter_set(cap, torch.where(keep, rank, torch.full_like(rank, cap)),
                       torch.where(keep, s, torch.full_like(s, INT32_MAX)), INT32_MAX)
    count = torch.clamp(is_first.sum(dtype=torch.int32), max=cap)
    return uniq, count, rank


def _unflatten(flat: torch.Tensor, spatial_shape) -> torch.Tensor:
    coords = []
    flat = flat.long()
    for st in _strides_of(spatial_shape):
        coords.append(torch.div(flat, st, rounding_mode="floor"))
        flat = torch.remainder(flat, st)
    return torch.stack(coords, -1).to(torch.int32)


def _down_candidates(in_grid: SparseGrid, kernel_size, stride, padding):
    """(out_shape, per-axis candidates [(o, tap, valid)]) of a strided conv:
    input i is covered on axis a by o = floor((i + p) / s) - j for j <
    ceil(k / s) whose window o*s - p + [0, k) holds i."""
    out_shape = tuple((int(d) + 2 * int(p) - int(k)) // int(s) + 1
                      for d, k, s, p in zip(in_grid.spatial_shape, kernel_size, stride, padding))
    per_axis = []
    for a in range(len(out_shape)):
        k_a, s_a, p_a = int(kernel_size[a]), int(stride[a]), int(padding[a])
        top = in_grid.coords[:, a].long() + p_a
        cands = []
        for j in range(-(-k_a // s_a)):
            o = torch.div(top, s_a, rounding_mode="floor") - j
            tap = top - o * s_a
            valid = in_grid.mask & (o * s_a >= top - k_a + 1) & (o >= 0) & (o < out_shape[a])
            cands.append((o, tap, valid))
        per_axis.append(cands)
    return out_shape, per_axis


def _site_grid(uniq, count, cap, out_shape) -> SparseGrid:
    mask = torch.arange(cap, device=uniq.device) < count
    coords = torch.where(mask[:, None], _unflatten(torch.where(mask, uniq, torch.zeros_like(uniq)),
                                                   out_shape),
                         torch.full((), -1, dtype=torch.int32, device=uniq.device))
    return SparseGrid(uniq, coords, mask, out_shape)


def downsample_with_index(in_grid: SparseGrid, kernel_size: Sequence[int],
                          stride: Sequence[int], padding: Sequence[int], out_cap: int,
                          forward: bool = True):
    """Downsample sites plus the forward and inverse indices from one
    candidate sort.

    Each (input row, covering output) candidate carries the payload
    row*K + tap + 1; after sorting by output id, a candidate's output row is
    the unique rank of its id, so scattering the ranks by payload gives the
    inverse index inv[i, k] (an input is read by at most one output per
    tap), and its transpose the forward index. Equal ids may come out of
    the sort in any order: the outputs read only the ids and the
    payload -> rank pairs.

    Returns (out_grid, idx [out_cap, K] in [0, N_in] or None when not
    `forward`, inv [N_in, K] in [0, out_cap]); tap order = kernel_offsets.
    """
    out_shape, per_axis = _down_candidates(in_grid, kernel_size, stride, padding)
    out_strides = _strides_of(out_shape)
    k_total = int(np.prod([int(k) for k in kernel_size]))
    k_strides = _strides_of(tuple(int(k) for k in kernel_size))
    n = in_grid.flat_ids.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=in_grid.flat_ids.device)
    id_cols, pay_cols = [], []
    for combo in itertools.product(*per_axis):
        flat = torch.zeros_like(rows)
        tap_flat = torch.zeros_like(rows)
        valid = in_grid.mask
        for a, (o, tap, v) in enumerate(combo):
            valid = valid & v
            flat = flat + o * out_strides[a]
            tap_flat = tap_flat + tap * k_strides[a]
        id_cols.append(torch.where(valid, flat, torch.full_like(flat, INT32_MAX)))
        pay_cols.append(torch.where(valid, rows * k_total + tap_flat + 1, torch.zeros_like(rows)))
    cand_ids = torch.cat(id_cols).to(torch.int32)
    cand_pay = torch.cat(pay_cols)
    ids_s, perm = torch.sort(cand_ids, stable=True)
    pay_s = cand_pay[perm]
    uniq, count, rank = _unique_sorted(ids_s, out_cap)
    out_grid = _site_grid(uniq, count, out_cap, out_shape)

    ok = (pay_s > 0) & (rank >= 0) & (rank < out_cap) & (ids_s != INT32_MAX)
    inv = scatter_set(n * k_total, torch.where(ok, pay_s - 1, torch.full_like(pay_s, n * k_total)),
                      torch.where(ok, rank, torch.full_like(rank, out_cap)), out_cap
                      ).reshape(n, k_total)
    idx = inverse_from_forward(inv, out_cap) if forward else None
    return out_grid, idx, inv


def xwin_from_index(idx: torch.Tensor, out_coords: torch.Tensor, out_mask: torch.Tensor,
                    kx: int, n_in: int, stride_x: int, pad_x: int, w_dim: int) -> XWindowInfo:
    """x-window form of a dense [N, K] index: each group's window is anchored
    at its first hit tap t0 with input row r (row r*kx + t0); xvalid is
    masked by `out_mask`."""
    n_out, k = idx.shape
    idx3 = idx.reshape(n_out, k // kx, kx).long()
    hit = idx3 < n_in
    any_hit = hit.any(2)
    # the first hit tap (0 when none), as argmax over the bools
    t0 = torch.full(any_hit.shape, 0, dtype=torch.int64, device=idx.device)
    for t in range(kx - 1, -1, -1):
        t0 = torch.where(hit[:, :, t], torch.full_like(t0, t), t0)
    r = torch.gather(idx3, 2, t0[:, :, None])[:, :, 0]
    rows = torch.where(any_hit, r * kx + t0, torch.full_like(r, n_in * kx)).to(torch.int32)
    lx = (out_coords[:, -1].long() * stride_x - pad_x)[:, None] + torch.arange(
        kx, dtype=torch.int64, device=idx.device)
    xvalid = out_mask[:, None] & (lx >= 0) & (lx < w_dim)
    return XWindowInfo(rows, xvalid, kx, n_in)


# -- the plan-fed path's conversions -------------------------------------------

def xwin_to_index(rows: torch.Tensor, xvalid: torch.Tensor, ids: torch.Tensor,
                  kx: int) -> torch.Tensor:
    """x-window relation -> dense neighbour index [M, G*kx].

    `rows[i, g]` = p*kx + d0 names the window whose base id is ids[p] - d0
    (miss = n*kx); tap t of group g reads the input row holding id
    ids[p] - d0 + t when `xvalid[i, t]`, else misses. Ids are sorted and
    unique, so that row is found by binary search; a missing id, a missed
    window or an x-invalid tap gives the miss index n = len(ids).
    """
    n = ids.shape[0]
    m, g = rows.shape
    rows = rows.long()
    hit = rows < n * kx
    p = torch.where(hit, rows // kx, torch.zeros_like(rows))
    d0 = rows - p * kx
    ids64 = ids.long()
    base = ids64[p] - d0                                    # [M, G]
    taps = torch.arange(kx, dtype=torch.int64, device=ids.device)
    target = base[:, :, None] + taps                        # [M, G, kx]
    pos = torch.searchsorted(ids64, target.reshape(-1)).reshape(m, g, kx)
    pos = torch.clamp(pos, max=n - 1)
    found = ids64[pos] == target
    ok = hit[:, :, None] & xvalid.bool()[:, None, :] & found
    idx = torch.where(ok, pos, torch.full_like(pos, n))
    return idx.reshape(m, g * kx).to(torch.int32)


def scatter_to_dense(features: torch.Tensor, grid: SparseGrid) -> torch.Tensor:
    """Scatter sparse features [N, C] into a dense [*spatial_shape, C] grid.

    Sites are unique, so a copy equals the JAX scatter-add; padding rows go
    to a scratch cell that is dropped.
    """
    shape = tuple(int(s) for s in grid.spatial_shape)
    c = features.shape[1]
    size = int(np.prod(shape, dtype=np.int64))
    strides = device_constant(
        [int(np.prod(shape[i + 1:], dtype=np.int64)) for i in range(len(shape))], torch.int64,
        features.device)
    flat = (grid.coords.long() * strides).sum(-1)
    flat = torch.where(grid.mask, flat, torch.full_like(flat, size))
    dense = torch.zeros((size + 1, c), dtype=features.dtype, device=features.device)
    dense.index_copy_(0, flat, features)
    return dense[:size].reshape(shape + (c,))


class _BijectiveGather(torch.autograd.Function):
    """out = [rows; 0][index]; d_rows = [g; 0][inverse]: each kept row feeds
    one target and `inverse` names it, so the gradient is a gather too."""

    @staticmethod
    def forward(ctx, rows, index, inverse):
        ctx.save_for_backward(inverse)
        pad = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])], 0)
        return pad.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        g_pad = torch.cat([g, g.new_zeros((1,) + g.shape[1:])], 0)
        return g_pad.index_select(0, inverse), None, None


def bijective_gather(rows: torch.Tensor, index: torch.Tensor,
                     inverse: torch.Tensor) -> torch.Tensor:
    """rows [N, C] gathered into [M, C] targets through `index` [M] int64 (N:
    the target is 0), differentiable in rows with the backward a gather
    through `inverse` [N] int64 (each row's target, M where it has none):
    for a map that sends each kept row to one target, equal bit for bit to
    the scatter-add that autograd of `rows[index]` would run, without its
    atomics (which pile up on the zero row)."""
    return _BijectiveGather.apply(rows, index, inverse)
