"""Exchange: hash shuffle and broadcast across the shards of a mesh.

Counterpart of ``tiflash_tpu/exchange/shuffle.py``.  Role analog: the
reference's MPP exchange stack (``HashPartitionWriter``,
``BroadcastOrPassThroughWriter``, ``MPPTunnel``, ``ExchangeReceiver``).
The sender, tunnel and receiver collapse into one collective of
``mpp/mesh.py`` over a list with one Block per local shard:

- hash repartition -> ``shuffle_block``, two wire modes;
- broadcast and passthrough -> ``allgather_block``: every shard gets
  every live row (the consumer then runs replicated).

Rows are hashed with the reference's ``hash_block_keys`` and
``partition_ids``, bit for bit, so every row lands on the shard the
reference sends it to, and grouped by destination with one stable sort
(dead rows last).

``shuffle_block``'s modes:

- ``'padded'``: the reference's CPU contract.  Each (source, destination)
  chunk has capacity ``C = max(ceil(out_cap / P), min(n, 64))``; shard j
  receives P*C rows, source i's chunk at ``[i*C, i*C + C)``, live where
  the offset is below what i sent.  Overflow reports ``max_send * P``
  when a chunk exceeds C.  Per shard, rows, dead rows and overflow equal
  the reference's.
- ``'ragged'``: exact sizes.  The (P, P) size matrix is read on the host
  once, each source sends exactly its rows, and shard j receives the
  sources' rows back to back in source order: a live prefix of a block
  of the padded mode's capacity P*C (so every later operator sees the
  same capacities in both modes).  Overflow reports ``total_recv`` when
  it exceeds P*C.  The live rows, in order, are the padded mode's.
- ``'auto'``: ragged on CUDA (the reference picks ragged on its
  accelerator), padded on the CPU.

The reference packs same-width columns into one matrix per collective (a
TPU wire-batching workaround); here each column moves on its own.

Each exchange adds the bytes written into the receiving shards' buffers
to a counter of ``runtime/metrics.py``, ``exchange_hash_bytes_total`` or
``exchange_gather_bytes_total``, from host-known sizes only: the padded
mode's P*C chunks, the ragged mode's size matrix, the gathered
capacities.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.block import Block, Column, as_dtype_bits, signed_bits
from ..ops.hashing import hash_block_keys, partition_ids
from ..runtime.metrics import METRICS


def _row_bytes(block: Block) -> int:
    """Bytes one row of ``block`` moves: each column's data and validity."""
    n = 0
    for c in block.columns:
        n += c.data.element_size() * (c.data[0].numel() if c.data.dim() > 1 else 1)
        if c.validity is not None:
            n += 1
    return n


def _local_group_by_partition(block: Block, pids: torch.Tensor, num_parts: int):
    """Stable sort of the rows by destination, dead rows last: (grouped
    block, send sizes (P,), input offsets (P,), sorted destinations)."""
    live = block.sel_mask()
    p = torch.where(live, pids.to(torch.int64),
                    torch.full_like(pids, num_parts, dtype=torch.int64))
    sorted_p, perm = torch.sort(p, stable=True)
    grouped = block.take(perm)
    bounds = torch.searchsorted(
        sorted_p, torch.arange(num_parts + 1, dtype=torch.int64, device=p.device))
    return grouped, bounds[1:] - bounds[:-1], bounds[:-1], sorted_p


def _arrays(col: Column):
    """The tensors a column moves: data (an unsigned column as its signed
    bits) and validity."""
    return signed_bits(col.data), col.validity


def _rebuild(col: Column, data: torch.Tensor, validity) -> Column:
    return Column(as_dtype_bits(data, col.data.dtype), validity, col.dtype, col.dictionary, stats=col.stats,
                  concat_sep=col.concat_sep)


def shuffle_block(blocks: Sequence[Block], keys: Sequence[str], mesh,
                  out_capacity: int, mode: str = "auto"
                  ) -> Tuple[List[Block], List[torch.Tensor]]:
    """Hash-repartition the live rows of every shard's block across the
    mesh.  Returns (one received block per local shard, each with its
    ``sel``; one int64 overflow value per local shard, 0 when it fit)."""
    if mode == "auto":
        mode = "ragged" if blocks[0].device.type == "cuda" else "padded"
    P = mesh.size
    groups = mesh.map(
        lambda b: _local_group_by_partition(b, partition_ids(hash_block_keys(b, keys), P),
                                            P),
        blocks)
    # size matrix S[i, j] = rows shard i sends to shard j, on every shard
    S = mesh.all_gather([g[1] for g in groups])
    # per (source, destination) chunk capacity; the floor keeps small
    # blocks (partial aggregates) safe when every row goes to one shard
    C = max(-(-out_capacity // P), min(groups[0][0].capacity, 64))
    if mode == "ragged":
        return _shuffle_ragged(groups, S, mesh, P * C)
    assert mode == "padded", mode
    METRICS.counter("exchange_hash_bytes_total").inc(
        mesh.local_size * P * C * _row_bytes(blocks[0]))
    return _shuffle_padded(groups, S, mesh, C)


def _shuffle_padded(groups, S, mesh, C):
    P = mesh.size
    n = groups[0][0].capacity

    def slots(g):
        _, send, offsets, row_p = g
        pos = (torch.arange(n, dtype=torch.int64, device=row_p.device)
               - offsets[row_p.clamp(0, P - 1)])
        slot = torch.where((row_p < P) & (pos < C), row_p * C + pos,
                           torch.full_like(pos, P * C))
        max_send = send.max()
        overflow = torch.where(max_send > C, max_send * P, torch.zeros_like(max_send))
        return slot, overflow

    sl = mesh.map(slots, groups)

    def exch(arrs):
        def scatter(arr, s):
            buf = torch.zeros((P * C + 1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                              device=arr.device)
            buf[s[0]] = arr
            return buf[: P * C].reshape((P, C) + tuple(arr.shape[1:]))

        bufs = mesh.map(scatter, arrs, sl)
        return [o.reshape((P * C,) + tuple(o.shape[2:])) for o in mesh.all_to_all(bufs)]

    grouped = [g[0] for g in groups]
    cols = _exchange_columns(grouped, exch)

    def sel_of(s, i):
        recv = s[:, mesh.axis_index(i)]
        off = torch.arange(C, dtype=torch.int64, device=s.device)
        return (off[None, :] < recv[:, None]).reshape(P * C)

    sels = [sel_of(S[i], i) for i in range(mesh.local_size)]
    out = [Block(names=grouped[0].names, columns=tuple(c[i] for c in cols), sel=sels[i])
           for i in range(mesh.local_size)]
    return out, [o[1] for o in sl]


def _shuffle_ragged(groups, S, mesh, out_capacity):
    P = mesh.size
    sizes = S[0].cpu().tolist()  # (P, P) host ints: the wire sizes
    starts = [[sum(row[:j]) for j in range(P)] for row in sizes]
    me = [mesh.axis_index(i) for i in range(mesh.local_size)]
    METRICS.counter("exchange_hash_bytes_total").inc(
        sum(sizes[s][j] for s in range(P) for j in me) * _row_bytes(groups[0][0]))

    def exch(arrs):
        parts = []
        for i, arr in enumerate(arrs):
            src = mesh.axis_index(i)
            parts.append([arr[starts[src][j]: starts[src][j] + sizes[src][j]]
                          for j in range(P)])
        recv = mesh.ragged_all_to_all(parts)
        out = []
        for r in recv:
            r = r[:out_capacity]
            if r.shape[0] < out_capacity:
                pad = torch.zeros((out_capacity - r.shape[0],) + tuple(r.shape[1:]),
                                  dtype=r.dtype, device=r.device)
                r = torch.cat([r, pad])
            out.append(r)
        return out

    grouped = [g[0] for g in groups]
    cols = _exchange_columns(grouped, exch)
    out, overflows = [], []
    for i in range(mesh.local_size):
        total = sum(sizes[s][me[i]] for s in range(P))
        dev = mesh.devices[i]
        sel = torch.arange(out_capacity, device=dev) < total
        out.append(Block(names=grouped[0].names,
                         columns=tuple(c[i] for c in cols), sel=sel))
        overflows.append(torch.tensor(total if total > out_capacity else 0,
                                      dtype=torch.int64, device=dev))
    return out, overflows


def _exchange_columns(grouped: List[Block], exch) -> List[List[Column]]:
    """Move every column (data, then validity) with ``exch`` (a list of
    per-shard tensors -> a list of received ones); per column, the list
    of received columns.  Stats survive: values only move."""
    cols = []
    for ci, c0 in enumerate(grouped[0].columns):
        shard_cols = [b.columns[ci] for b in grouped]
        data = exch([_arrays(c)[0] for c in shard_cols])
        if any(c.validity is not None for c in shard_cols):
            validity = exch([c.valid_mask() for c in shard_cols])
        else:
            validity = [None] * len(shard_cols)
        cols.append([_rebuild(c0, d, v) for d, v in zip(data, validity)])
    return cols


def allgather_block(blocks: Sequence[Block], mesh) -> List[Block]:
    """Broadcast: every shard gets every shard's rows, concatenated in
    shard order, with ``sel`` kept as a mask (the broadcast-join build
    side and the passthrough gather)."""
    cols = []
    for ci, c0 in enumerate(blocks[0].columns):
        shard_cols = [b.columns[ci] for b in blocks]
        data = mesh.all_gather_tiled([_arrays(c)[0] for c in shard_cols])
        if any(c.validity is not None for c in shard_cols):
            validity = mesh.all_gather_tiled([c.valid_mask() for c in shard_cols])
        else:
            validity = [None] * len(data)
        stats = None
        if all(c.stats is not None for c in shard_cols):
            stats = (min(c.stats[0] for c in shard_cols),
                     max(c.stats[1] for c in shard_cols))
        nullable = any(c.dtype.nullable for c in shard_cols)
        c0 = Column(c0.data, c0.validity, c0.dtype.with_nullable(nullable),
                    c0.dictionary, stats=stats, concat_sep=c0.concat_sep)
        cols.append([_rebuild(c0, d, v) for d, v in zip(data, validity)])
    sels = mesh.all_gather_tiled([b.sel_mask() for b in blocks])
    METRICS.counter("exchange_gather_bytes_total").inc(
        len({id(x) for x in sels}) * mesh.size * blocks[0].capacity
        * (_row_bytes(blocks[0]) + 1))
    out = []
    memo: dict = {}
    for i in range(mesh.local_size):
        key = (id(sels[i]),) + tuple(id(c[i].data) for c in cols)
        if key not in memo:
            memo[key] = Block(names=blocks[0].names,
                              columns=tuple(c[i] for c in cols), sel=sels[i])
        out.append(memo[key])
    return out


__all__ = ["shuffle_block", "allgather_block"]
