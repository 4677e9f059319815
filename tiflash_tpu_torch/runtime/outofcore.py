"""Out-of-core execution: chunked aggregation, group-partitioned
aggregation, grace hash join and sliced (external) sort.

Counterpart of ``tiflash_tpu/runtime/outofcore.py``.  Role analog: the
reference engine's spill machinery (``Core/Spiller.h:87``, aggregation
spill and ``MergingBuckets`` restore, join restore rounds
``Interpreters/Join.h:95-100``, sort spill
``Interpreters/SortSpillContext.h``).  Instead of spilling state out of
device memory mid-query, the working set never exceeds the budget: the
host splits the inputs, the device runs the plan once per piece, and host
RAM (or ``spill_dir`` through ``runtime/spill.py``) holds the pieces'
outputs:

- ``run_chunked_aggregate``: row-slice the base table, partial-aggregate
  each chunk, merge the partial states (in group-key-hash buckets above
  ``_FINAL_MERGE_ROWS`` partial rows);
- ``run_groupagg``: hash-partition the base table by group key, run the
  whole plan per partition (any aggregate is exact), re-apply the
  reducing wrappers;
- ``run_grace_join``: hash-partition the join's base table(s) by key
  (the build replicated whole when it fits), run the whole plan per
  partition, re-apply the reducing wrappers;
- ``run_sliced``: row-sliced sort/top-N runs, then one merge pass.

Partition counts, chunk sizes and the host key hash
(``_hash_host_triples``: splitmix64 over the key values, CRC32 of
dictionary strings) are the reference's bit for bit, so partitions hold
the same rows.  Two departures, each giving the same rows in the same
order:

- the reference's ``_partition_block`` puts all P partitions on the
  device at once; here partitions stay on the host (``_HostPartitions``)
  and one is copied to the device per run, through pinned staging
  buffers reused across partitions;
- the reference finds each partition with ``np.nonzero(pid == p)``
  (O(P·n) on the host); here one stable argsort of ``pid`` groups the
  rows;
- the reference's chunked aggregate keeps its partial states in host RAM
  whatever ``spill_dir`` says; here they go through the same PartStore as
  the other paths' outputs, so with ``spill_dir`` they wait on disk.

A partition's staged copy carries a ``narrow32`` shadow (cast on the
device) wherever the table's column has one, so a fused aggregation over
a partition reads the storage it reads over the whole table.

Every piece runs on the device the tables are on.  A partition's device
copy and its output live only for its run: the output is compacted and
copied to the host at once.  ``checkpoint()`` runs between chunks,
partitions and merge buckets, so a cancelled query stops at the next
one.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.block import Block, Column
from ..exchange.skew import concat_blocks
from ..plan import nodes as P
from ..plan.compiler import compile_fragment


def _check_flags(flags: Dict, what: str) -> None:
    """Raise runtime-eval errors, then treat any remaining positive flag
    as a capacity overflow (out-of-core paths size pieces up front, so an
    overflow here is a bug, not a retry signal)."""
    from .errors import raise_runtime_errors, split_runtime_errors
    from .executor import read_flags

    overflows, rterrs = split_runtime_errors(read_flags(flags))
    raise_runtime_errors(rterrs)
    for k, v in overflows.items():
        if v > 0:
            raise RuntimeError(f"{what} overflow at {k}")


def _scan_tables(node: P.PlanNode) -> List[str]:
    if isinstance(node, P.TableScan):
        return [node.table]
    out: List[str] = []
    for c in node.children:
        out.extend(_scan_tables(c))
    return out


def _has_join(node: P.PlanNode) -> bool:
    if isinstance(node, (P.Join, P.CrossJoin)):
        return True
    return any(_has_join(c) for c in node.children)


def chunkable(plan: P.PlanNode) -> bool:
    """A root Aggregation whose input reads exactly one table, with no
    join (row-slicing a self-join would slice both sides), and whose
    aggregates all decompose into partial and final states."""
    if not isinstance(plan, P.Aggregation):
        return False
    if any(a.func not in ("sum", "count", "avg", "min", "max", "first")
           for a in plan.aggs):
        return False
    if _has_join(plan.child):
        return False
    return len(set(_scan_tables(plan.child))) == 1


def _device_of(tables: Dict[str, Block]) -> torch.device:
    return next(iter(tables.values())).device


def _slice_block(block: Block, start: int, rows: int) -> Block:
    """Rows [start, start + rows) as views, with the reference's column
    metadata (type, dictionary, stats)."""
    cols = tuple(
        Column(c.data[start:start + rows],
               None if c.validity is None else c.validity[start:start + rows],
               c.dtype, c.dictionary, stats=c.stats)
        for c in block.columns)
    sel = None if block.sel is None else block.sel[start:start + rows]
    return Block(names=block.names, columns=cols, sel=sel)


def _padded_slice(base: Block, start: int, rows: int, chunk_rows: int) -> Block:
    """A chunk padded to ``chunk_rows`` with dead rows, so every chunk has
    one shape."""
    chunk = _slice_block(base, start, rows)
    if rows < chunk_rows:
        pad = chunk_rows - rows
        filler = _slice_block(base, 0, pad).and_sel(
            torch.zeros(pad, dtype=torch.bool, device=base.device))
        chunk = concat_blocks(chunk, filler)
    return chunk


def run_chunked_aggregate(plan: P.Aggregation, tables: Dict[str, Block],
                          chunk_rows: int, fuse_stream_agg: bool = True,
                          info: Optional[dict] = None, spill_dir: str = "",
                          nthreads: int = 0) -> Block:
    """Run ``plan`` staging at most ``chunk_rows`` rows of the base table
    (plus partial states) at a time.  The partials wait for the final
    merge in a PartStore: on disk with ``spill_dir``.  ``info``, when
    given, receives the chunk count (``pieces``), the partial rows, and
    for a bucketed final merge the bucket counts tried (``merge_tries``)
    and the one that answered (``merge_buckets``, 0 for the host
    merge)."""
    from .cancel import checkpoint
    from .distribute_helpers import build_partial_final
    from .metrics import METRICS

    partial_plan, final_plan_builder = build_partial_final(plan)
    # a chunk holds at most chunk_rows distinct keys: shrink the chunk
    # program's slot capacity (autosize sized it for the whole table)
    if isinstance(partial_plan, P.Aggregation) and partial_plan.num_slots:
        cap = 1 << (2 * chunk_rows - 1).bit_length()
        partial_plan.num_slots = min(partial_plan.num_slots, cap)
    table_name = _scan_tables(plan.child)[0]
    base = tables[table_name]
    device = base.device
    n = base.capacity
    fn = compile_fragment(partial_plan, fuse_stream_agg)
    store = _part_store(spill_dir, "chunked", nthreads)
    try:
        start = chunk = 0
        while start < n:
            checkpoint()  # cancellable between chunks
            METRICS.counter("ooc_chunks_total").inc()
            rows = min(chunk_rows, n - start)
            sub = dict(tables)
            sub[table_name] = _padded_slice(base, start, rows, chunk_rows)
            out, overflows = fn(sub)
            _check_flags(overflows, "chunked aggregate")
            # the partial's live rows go to the host at once: the device
            # copy at its full slot capacity must not outlive the chunk
            _store_add(store, _to_host_rows(out), chunk)
            del sub, out
            start += rows
            chunk += 1
        partials = [(names, cols, len(cols[0][0])) for names, cols in _store_parts(store)]
    finally:
        store.close()

    total_partial_rows = sum(p[2] for p in partials)
    if info is not None:
        info.update(pieces=len(partials), partial_rows=total_partial_rows)
    if total_partial_rows <= _FINAL_MERGE_ROWS:
        merged = _concat_host_parts(partials, device)
        ffn = compile_fragment(final_plan_builder(), fuse_stream_agg)
        out, overflows = ffn({"__partials": merged})
        _check_flags(overflows, "chunked final")
        return out
    return _bucketed_final_merge(plan, final_plan_builder, partials, device,
                                 info)


# ---------------------------------------------------------------------------
# grace hash join (join spill / restore-round analog)
# ---------------------------------------------------------------------------

# top-level join kinds that partition cleanly by key hash (NULL-aware
# kinds need the whole build side for NULL probe keys; cross has no keys)
_GRACE_KINDS = {"inner", "left", "semi", "anti", "left_outer_semi",
                "right_outer", "full_outer"}
# kinds with no build-side tail: safe with a replicated build side
_NO_BUILD_TAIL = {"inner", "left", "semi", "anti", "left_outer_semi"}


def _resolve_key_base(node: P.PlanNode, key: str):
    """Trace a join-key column through a pipeline to its base-table
    column: (table, base_col) or None.  Through Selection, Projection
    renames, an Aggregation keyed on it, and a Join's probe side (or an
    inner join's build side)."""
    from ..expr.nodes import ColumnRef

    if isinstance(node, P.TableScan):
        return (node.table, key)
    if isinstance(node, P.Selection):
        return _resolve_key_base(node.child, key)
    if isinstance(node, P.Projection):
        e = node.exprs.get(key)
        if not isinstance(e, ColumnRef):
            return None
        return _resolve_key_base(node.child, e.name)
    if isinstance(node, P.Aggregation):
        if key not in node.keys:
            return None
        return _resolve_key_base(node.child, key)
    if isinstance(node, P.Join):
        r = _resolve_key_base(node.probe, key)
        if r is not None:
            return r
        if node.kind == "inner":
            return _resolve_key_base(node.build, key)
        return None
    return None


_WRAPPERS = (P.TopN, P.Sort, P.Limit, P.Projection, P.Selection)


def grace_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection|Aggregation]* Join``
    where both join sides resolve their keys to base-table columns.
    Returns a dict spec or None."""
    wrappers = []
    node = plan
    while isinstance(node, _WRAPPERS + (P.Aggregation,)):
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.Join) or node.kind not in _GRACE_KINDS:
        return None
    key_names = set(node.probe_keys) | set(node.build_keys)
    for w in wrappers:
        if isinstance(w, P.Aggregation) and not (set(w.keys) & key_names):
            return None  # groups would span partitions
    probe_base = [_resolve_key_base(node.probe, k) for k in node.probe_keys]
    build_base = [_resolve_key_base(node.build, k) for k in node.build_keys]
    if any(b is None for b in probe_base + build_base):
        return None
    if len({t for t, _ in probe_base}) != 1 or len({t for t, _ in build_base}) != 1:
        return None  # each side partitions exactly one base table
    pt, bt = probe_base[0][0], build_base[0][0]
    clone = None
    if pt == bt:
        # self-join / shared scan: each side partitions the same table
        # by its own keys, so the build subtree reads it under a cloned name
        clone = bt + "__grace_build"
        bt = clone
    return {
        "wrappers": wrappers,
        "join": node,
        "probe_table": pt,
        "probe_cols": [c for _, c in probe_base],
        "build_table": bt,
        "build_cols": [c for _, c in build_base],
        "clone_build_scan": clone,
    }


def _clone_scan(node: P.PlanNode, old: str, new: str) -> P.PlanNode:
    """Copy a subtree with TableScan(old) renamed to TableScan(new)."""
    if isinstance(node, P.TableScan):
        if node.table == old:
            return P.TableScan(new, columns=node.columns)
        return node
    n2 = copy.copy(node)
    kids = tuple(_clone_scan(c, old, new) for c in node.children)
    n2.children = kids
    if hasattr(n2, "child") and len(kids) == 1:
        n2.child = kids[0]
    if hasattr(n2, "probe") and len(kids) == 2:
        n2.probe, n2.build = kids
    return n2


def _rewrap(wrappers, node: P.PlanNode) -> P.PlanNode:
    """Stack copies of ``wrappers`` (outermost first) over ``node``."""
    for w in reversed(wrappers):
        w2 = copy.copy(w)
        w2.child = node
        w2.children = (node,)
        node = w2
    return node


def _host_array(t: Optional[torch.Tensor]):
    return None if t is None else t.cpu().numpy()


def _hash_host_triples(triples, n: int) -> np.ndarray:
    """Splitmix64 over host (data, validity, dictionary) column triples,
    the reference's hash bit for bit: a dictionary string hashes by the
    CRC32 of its text, a multi-plane column by the XOR of its planes, a
    NULL as 0."""
    import zlib

    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for data, validity, dictionary in triples:
        data = np.asarray(data)
        if dictionary is not None:
            lut = np.fromiter(
                (zlib.crc32(s.encode()) for s in dictionary),
                dtype=np.uint64, count=len(dictionary),
            ) if dictionary else np.zeros(1, dtype=np.uint64)
            x = lut[np.clip(data, 0, max(len(lut) - 1, 0))]
        else:
            x = data.astype(np.int64).view(np.uint64)
            if x.ndim > 1:
                x = np.bitwise_xor.reduce(x, axis=tuple(range(1, x.ndim)))
        if validity is not None:
            v = np.asarray(validity)
            if v.ndim > 1:
                v = v.all(axis=tuple(range(1, v.ndim)))
            x = np.where(v, x, np.uint64(0))
        # splitmix64 finalizer
        z = (h ^ x) * np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        h = z ^ (z >> np.uint64(31))
    return h


def _host_key_hash(block: Block, cols: List[str]) -> np.ndarray:
    """Value-based uint64 hash of the key columns, on the host (strings
    by value, so co-partitioning holds across dictionaries)."""
    return _hash_host_triples(
        ((_host_array(block[name].data), _host_array(block[name].validity),
          block[name].dictionary) for name in cols),
        block.capacity)


def _group_order(pid: np.ndarray, P_: int) -> Tuple[np.ndarray, np.ndarray]:
    """(row order grouping rows by partition, in their original order
    within each; partition start offsets, length P_ + 1).  The ids sort as
    int16 (P_ <= 4096), which numpy's stable sort takes by radix."""
    order = np.argsort(pid.astype(np.int16), kind="stable")
    counts = np.bincount(pid, minlength=P_)
    starts = np.zeros(P_ + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts


class _HostPartitions:
    """A table's rows grouped by partition on the host.  ``block(p)``
    copies partition ``p`` to the device padded to ``cap`` rows (dead pad
    rows repeat the table's row 0, as the reference's pad index 0 does),
    through pinned staging buffers that every partition reuses: the
    previous copy is waited for before a buffer is refilled."""

    def __init__(self, block: Block, pid: np.ndarray, P_: int, cap: int):
        order, self.starts = _group_order(pid, P_)
        self.block_meta = block
        self.cap = cap
        self.device = block.device
        if self.device.type == "cuda":
            # gather where the rows are, then one copy of each column to
            # the host
            idx = torch.from_numpy(order).to(self.device)

            def grouped(t):
                if t.dtype == torch.uint64:  # CUDA cannot index uint64
                    return t.view(torch.int64)[idx].view(torch.uint64).cpu().numpy()
                return t[idx].cpu().numpy()
        else:
            def grouped(t):
                return t.numpy()[order]
        self.cols = []
        for c in block.columns:
            valid = c.validity
            self.cols.append((grouped(c.data), None if valid is None else grouped(valid),
                              c.data[:1].cpu().numpy(),
                              None if valid is None else valid[:1].cpu().numpy()))
        self._staging: Optional[List] = None
        self._copied = None  # CUDA event after the last partition's copies

    def _stage(self, i: int, rows: np.ndarray, pad_row: np.ndarray) -> torch.Tensor:
        """``rows`` then copies of ``pad_row`` up to ``cap`` rows, on the
        device; on the card through pinned staging buffer ``i``."""
        n = len(rows)
        if self.device.type != "cuda":
            return torch.from_numpy(
                np.concatenate([rows, np.repeat(pad_row, self.cap - n, axis=0)]))
        buf = self._staging[i].numpy()
        buf[:n] = rows
        buf[n:] = pad_row
        return self._staging[i].to(self.device, non_blocking=True)

    def block(self, p: int) -> Block:
        s, e = int(self.starts[p]), int(self.starts[p + 1])
        n, cap = e - s, self.cap
        if self.device.type == "cuda":
            if self._copied is not None:
                self._copied.synchronize()
            if self._staging is None:
                self._staging = []
                for data, valid, _, _ in self.cols:
                    self._staging.append(torch.empty(
                        (cap,) + data.shape[1:], dtype=torch.from_numpy(data[:0]).dtype,
                        pin_memory=True))
                    if valid is not None:
                        self._staging.append(torch.empty(
                            (cap,) + valid.shape[1:], dtype=torch.bool, pin_memory=True))
        cols, i = [], 0
        for c, (data, valid, d0, v0) in zip(self.block_meta.columns, self.cols):
            dev_data = self._stage(i, data[s:e], d0)
            i += 1
            dev_valid = None
            if valid is not None:
                dev_valid = self._stage(i, valid[s:e], v0)
                i += 1
            narrow = None if c.narrow32 is None else dev_data.to(torch.int32)
            cols.append(Column(dev_data, dev_valid, c.dtype, c.dictionary,
                               stats=c.stats, narrow32=narrow))
        sel = torch.arange(cap, device=self.device) < n
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return Block(names=self.block_meta.names, columns=tuple(cols), sel=sel,
                     clustered_by=self.block_meta.clustered_by)


def _to_host_rows(block: Block) -> Tuple[Tuple[str, ...], List, int]:
    """Compacted host copy of a block's live rows: host arrays and light
    metadata only, so no device tensor outlives the piece's run."""
    b = block.compact()
    n = int(b.num_rows())
    cols = []
    for c in b.columns:
        data = c.data[:n].cpu().numpy()
        validity = None if c.validity is None else c.validity[:n].cpu().numpy()
        cols.append((data, validity, (c.dtype, c.dictionary, c.stats)))
    return b.names, cols, n


def _part_store(spill_dir: str, tag: str, nthreads: int = 0):
    """A PartStore of (names, [(data, validity, meta)]) parts; with a
    spill dir the arrays live in compressed chunk files."""
    import os

    from .spill import PartStore

    d = ""
    if spill_dir:
        d = os.path.join(spill_dir, f"{tag}-{os.getpid()}")
    return PartStore(d, nthreads=nthreads)


def _store_add(store, part, partition: int) -> None:
    names, cols, _n = part
    flat: List = []
    for data, validity, _meta in cols:
        flat.append(data)
        flat.append(validity)
    store._metas = [m for _, _, m in cols]  # identical across parts
    store.add(names, flat, partition)


def _store_parts(store):
    out = []
    for names, flat in store.parts():
        cols = [(flat[2 * i], flat[2 * i + 1], meta)
                for i, meta in enumerate(store._metas)]
        out.append((names, cols))
    return out


def _concat_host_parts(parts, device) -> Block:
    """One device block of the parts' rows in order.  Range stats cover
    every part (or are dropped)."""
    names = parts[0][0]
    cols = []
    for i in range(len(parts[0][1])):
        datas = [p[1][i][0] for p in parts]
        dtype, dictionary, stats = parts[0][1][i][2]
        if stats is not None:
            allst = [p[1][i][2][2] for p in parts]
            if any(s is None for s in allst):
                stats = None
            else:
                stats = (min(s[0] for s in allst), max(s[1] for s in allst))
        data = np.concatenate(datas) if datas else np.zeros(0)
        if any(p[1][i][1] is not None for p in parts):
            validity = np.concatenate([
                p[1][i][1] if p[1][i][1] is not None
                else np.ones(len(p[1][i][0]), dtype=bool)
                for p in parts])
        else:
            validity = None
        cols.append(Column(torch.as_tensor(data, device=device),
                           None if validity is None
                           else torch.as_tensor(validity, device=device),
                           dtype, dictionary, stats=stats))
    return Block(names=names, columns=tuple(cols), sel=None)


# One final-merge program's input capacity (rows of partial states).
# Above it the merge runs in group-key-hash buckets
# (``_bucketed_final_merge``), each a bounded device working set.
_FINAL_MERGE_ROWS = 4 << 20


def _split_host_part(part, key_idx, P_: int):
    """Split one host partial (names, cols, n) into per-bucket parts by
    group-key hash; yields (bucket, sub_part), empty buckets skipped."""
    names, cols, n = part
    h = _hash_host_triples(
        ((cols[i][0], cols[i][1], cols[i][2][1]) for i in key_idx), n)
    pid = (h % np.uint64(P_)).astype(np.int64)
    order, starts = _group_order(pid, P_)
    for p in range(P_):
        s, e = int(starts[p]), int(starts[p + 1])
        if s == e:
            continue
        idx = order[s:e]
        sub = [(d[idx], None if v is None else v[idx], meta) for d, v, meta in cols]
        yield p, (names, sub, e - s)


def _stage_host_parts_padded(parts, cap: int, device) -> Block:
    """Concatenate host parts into one device block padded to ``cap``
    rows with a live-row mask; pad rows repeat the last live row so range
    stats stay sound."""
    names = parts[0][0]
    n = sum(len(p[1][0][0]) for p in parts)
    assert n <= cap, (n, cap)
    cols = []
    for i in range(len(parts[0][1])):
        dtype, dictionary, stats = parts[0][1][i][2]
        if stats is not None:
            allst = [p[1][i][2][2] for p in parts]
            stats = None if any(s is None for s in allst) else (
                min(s[0] for s in allst), max(s[1] for s in allst))
        data = np.concatenate([p[1][i][0] for p in parts])
        validity = None
        if any(p[1][i][1] is not None for p in parts):
            validity = np.concatenate([
                p[1][i][1] if p[1][i][1] is not None
                else np.ones(len(p[1][i][0]), dtype=bool) for p in parts])
        pad = [(0, cap - n)] + [(0, 0)] * (data.ndim - 1)
        data = np.pad(data, pad, mode="edge" if n else "constant")
        if validity is not None:
            vpad = [(0, cap - n)] + [(0, 0)] * (validity.ndim - 1)
            validity = np.pad(validity, vpad, mode="edge" if n else "constant")
        cols.append(Column(torch.as_tensor(data, device=device),
                           None if validity is None
                           else torch.as_tensor(validity, device=device),
                           dtype, dictionary, stats=stats if n else None))
    sel = torch.arange(cap, device=device) < n
    return Block(names=names, columns=tuple(cols), sel=sel)


def _bucketed_final_merge(plan: P.Aggregation, final_plan_builder, partials,
                          device, info: Optional[dict] = None) -> Block:
    """Merge the partial states in group-key-hash buckets (the reference
    engine's ``MergingBuckets`` restore, ``Aggregator.cpp:1268``): every
    group lies whole in one bucket, so one small final plan per bucket is
    exact and the bucket outputs concatenate.

    The fallback ladder is the reference's: the agg core and any
    post-projection run as separate plans at the natural bucket count,
    then at 4x the buckets, then the host merge (``_host_final_merge``).
    A rung fails on ``FailPointError`` (failpoint
    ``compile_failure_in_final_merge``), the reference's stand-in for a
    compile-service failure; unarmed, the first rung runs."""
    from .failpoint import FailPointError
    from .logging import get_logger
    from .metrics import METRICS

    total = sum(p[2] for p in partials)
    P_ = 1
    while total // P_ > _FINAL_MERGE_ROWS and P_ < 1024:
        P_ *= 2
    names = partials[0][0]
    key_idx = [names.index(k) for k in plan.keys]
    log = get_logger("tiflash_tpu_torch.outofcore")
    METRICS.counter("ooc_final_merges_total").inc()
    for p_try in dict.fromkeys((P_, min(P_ * 4, 4096))):
        if info is not None:
            info.setdefault("merge_tries", []).append(p_try)
            info["merge_buckets"] = p_try
        try:
            return _device_bucket_merge(final_plan_builder, partials, key_idx,
                                        p_try, device)
        except FailPointError as e:
            METRICS.counter("ooc_compile_fallbacks_total").inc()
            log.warning("bucketed final merge at %d buckets failed (%s); "
                        "stepping down the fallback ladder", p_try, e)
    METRICS.counter("ooc_host_merges_total").inc()
    if info is not None:
        info["merge_buckets"] = 0  # the host merge
    log.warning("bucketed final merge: device rungs failed; falling back to "
                "the host-side merge")
    return _host_final_merge(plan, final_plan_builder, partials, device)


def _split_final(final_plan: P.PlanNode):
    """(wrappers above the final Aggregation, outermost first; the
    Aggregation)."""
    wrappers: List[P.PlanNode] = []
    agg = final_plan
    while not isinstance(agg, P.Aggregation):
        wrappers.append(agg)
        agg = agg.child
    return wrappers, agg


def _device_bucket_merge(final_plan_builder, partials, key_idx, P_: int,
                         device) -> Block:
    """One bucketed-merge attempt at ``P_`` buckets: the agg core and any
    post-projection (avg's division) as separate plans."""
    from .cancel import checkpoint
    from .failpoint import fail_point
    from .logging import get_logger

    fail_point("compile_failure_in_final_merge")
    buckets: List[List] = [[] for _ in range(P_)]
    for part in partials:
        for p, sub in _split_host_part(part, key_idx, P_):
            buckets[p].append(sub)
    rows = [sum(s[2] for s in b) for b in buckets]
    if max(rows) > _FINAL_MERGE_ROWS:
        get_logger("tiflash_tpu_torch.outofcore").warning(
            "bucketed final merge: largest bucket holds %d partial rows, "
            "above the %d-row budget at %d buckets", max(rows),
            _FINAL_MERGE_ROWS, P_)
    cap = int(-(-max(max(rows), 1) // 8192) * 8192)

    wrappers, agg = _split_final(final_plan_builder())
    if agg.num_slots:
        # a bucket holds <= cap group rows: the chunk program's rule
        agg.num_slots = min(agg.num_slots, 1 << (2 * cap - 1).bit_length())
    ffn = compile_fragment(agg)
    pfn = compile_fragment(_rewrap(wrappers, P.TableScan("__m"))) if wrappers else None

    outs = []
    for p in range(P_):
        if not buckets[p]:
            continue
        checkpoint()  # cancellable between buckets
        out, overflows = ffn(
            {"__partials": _stage_host_parts_padded(buckets[p], cap, device)})
        _check_flags(overflows, "chunked final bucket")
        if pfn is not None:
            out, overflows = pfn({"__m": out})
            _check_flags(overflows, "chunked final bucket post")
        outs.append(_to_host_rows(out))
        del out
    return _concat_host_parts(outs, device)


def _host_final_merge(plan: P.Aggregation, final_plan_builder, partials,
                      device) -> Block:
    """Last ladder rung: merge the partial states on the host with numpy
    (one stable lexsort by group key, segment reductions); any
    post-projection runs through the engine in uniform slices, so
    division and rounding stay the engine's."""
    from ..ops.aggregate import agg_result_dtype

    names = list(partials[0][0])
    ncols = len(names)
    datas, valids = [], []
    for i in range(ncols):
        datas.append(np.concatenate([p[1][i][0] for p in partials]))
        if any(p[1][i][1] is not None for p in partials):
            valids.append(np.concatenate([
                p[1][i][1] if p[1][i][1] is not None
                else np.ones(len(p[1][i][0]), dtype=bool)
                for p in partials]))
        else:
            valids.append(None)
    metas = [partials[0][1][i][2] for i in range(ncols)]

    wrappers, agg = _split_final(final_plan_builder())
    key_idx = [names.index(k) for k in agg.keys]
    used = key_idx + [names.index(a.arg) for a in agg.aggs if a.arg is not None]
    for i in used:
        if datas[i].ndim != 1:
            raise NotImplementedError(
                "host final merge over a multi-plane (wide-limb) partial"
                f" column {names[i]!r}: the device rungs are the only exact"
                " merge for this shape")

    n = len(datas[0]) if datas else 0
    sort_keys = []
    for i in key_idx:
        sort_keys.append(datas[i])
        if valids[i] is not None:
            sort_keys.append(valids[i])
    if n:
        order = (np.lexsort(sort_keys[::-1]) if sort_keys
                 else np.arange(n, dtype=np.int64))
        diff = np.zeros(n, dtype=bool)
        diff[0] = True
        for arr in sort_keys:
            a = arr[order]
            diff[1:] |= a[1:] != a[:-1]
        starts = np.nonzero(diff)[0]
    else:
        order = np.arange(0, dtype=np.int64)
        starts = np.zeros(0, dtype=np.int64)
    g = len(starts)

    out_names: List[str] = []
    out_cols: List = []
    for k, i in zip(agg.keys, key_idx):
        out_names.append(k)
        kd = datas[i][order][starts]
        kv = None if valids[i] is None else valids[i][order][starts]
        out_cols.append((kd, kv, metas[i]))
    i64max = np.longdouble(2) ** 63
    for a in agg.aggs:
        ai = names.index(a.arg)
        d = datas[ai][order]
        v = None if valids[ai] is None else valids[ai][order]
        dtype, dictionary, _stats = metas[ai]
        rdt = agg_result_dtype(a.func, dtype)
        ov = None if v is None else (
            np.add.reduceat(v.astype(np.int64), starts) > 0 if g
            else np.zeros(0, dtype=bool))
        if a.func == "sum":
            contrib = np.where(v, d, d.dtype.type(0)) if v is not None else d
            s = np.add.reduceat(contrib, starts) if g else contrib[:0]
            if np.issubdtype(d.dtype, np.integer) and g:
                shadow = np.add.reduceat(contrib.astype(np.longdouble), starts)
                if np.any(np.abs(shadow) >= i64max):
                    raise RuntimeError("host final merge: int64 sum overflow")
            out = s
        elif a.func in ("min", "max"):
            if np.issubdtype(d.dtype, np.floating):
                ident = np.inf if a.func == "min" else -np.inf
            else:
                info = np.iinfo(d.dtype)
                ident = info.max if a.func == "min" else info.min
            contrib = np.where(v, d, d.dtype.type(ident)) if v is not None else d
            red = np.minimum if a.func == "min" else np.maximum
            out = red.reduceat(contrib, starts) if g else contrib[:0]
        elif a.func == "first":
            # the lexsort is stable: each group's first partial in chunk
            # order, as the device merge picks
            out = d[starts]
            ov = None if v is None else v[starts]
        else:
            raise NotImplementedError(f"host final merge of {a.func}")
        if rdt.nullable and ov is None:
            ov = np.ones(g, dtype=bool)
        out_names.append(a.name)
        # recomputed, not inherited: a merged sum can exceed every
        # partial's range
        out_cols.append((out, ov, (rdt, dictionary, None)))

    merged = (tuple(out_names), out_cols, g)
    if not wrappers:
        return _concat_host_parts([merged], device)

    pfn = compile_fragment(_rewrap(wrappers, P.TableScan("__m")))
    rows_per = min(max(g, 1), _FINAL_MERGE_ROWS)
    cap = int(-(-rows_per // 8192) * 8192) or 8192
    outs = []
    start = 0
    while True:
        rows = min(rows_per, g - start) if g else 0
        sl = (merged[0],
              [(d[start:start + rows], None if v is None else v[start:start + rows], m)
               for d, v, m in merged[1]],
              rows)
        out, overflows = pfn({"__m": _stage_host_parts_padded([sl], cap, device)})
        _check_flags(overflows, "host final merge post")
        outs.append(_to_host_rows(out))
        start += rows
        if start >= g:
            break
    return _concat_host_parts(outs, device)


def _reapply_reducers(wrappers, merged: Block) -> Block:
    """Re-run the reducing wrappers (outermost last) over the
    concatenated piece outputs.  Projection/Selection already ran per
    piece; a partition-local Aggregation needs no re-merge."""
    for w in reversed(wrappers):
        if isinstance(w, P.TopN):
            mini = P.TopN(w.sort_keys, w.limit, P.TableScan("__oc"))
        elif isinstance(w, P.Sort):
            mini = P.Sort(w.sort_keys, P.TableScan("__oc"))
        elif isinstance(w, P.Limit):
            mini = P.Limit(w.limit, P.TableScan("__oc"))
        else:
            continue
        out, overflows = compile_fragment(mini)({"__oc": merged})
        _check_flags(overflows, "out-of-core merge")
        merged = out.compact()
    return merged


def _partition_count(big: int, budget_bytes: int, h: np.ndarray,
                     rows: int) -> int:
    """The reference's partition count: halve the bytes until a quarter
    of the budget holds a partition (at most 256), then double until the
    largest partition fits (counts.max() x row bytes x 4 <= budget) or
    holds at most 8192 rows (at most 4096 partitions)."""
    P_ = 1
    while big // P_ > max(budget_bytes // 4, 1):
        P_ *= 2
    P_ = min(P_, 256)
    row_bytes = max(1, big // max(rows, 1))
    while P_ < 4096:
        counts = np.bincount((h % np.uint64(P_)).astype(np.int64), minlength=P_)
        if int(counts.max()) * row_bytes * 4 <= budget_bytes or \
                int(counts.max()) <= 8192:
            break
        P_ *= 2
    return P_


def _run_partitions(plan, tables, P_, staged: Dict[str, object], spill_dir,
                    nthreads, tag, fuse_stream_agg) -> Block:
    """Run ``plan`` once per partition with each staged table (a
    ``_HostPartitions``, or a Block replicated to every partition) in
    place of its table; outputs go to a PartStore (disk with
    ``spill_dir``) and concatenate in partition order."""
    from .cancel import checkpoint

    fn = compile_fragment(plan, fuse_stream_agg)
    device = _device_of(tables)
    store = _part_store(spill_dir, tag, nthreads)
    try:
        for p in range(P_):
            checkpoint()
            sub = dict(tables)
            for name, src in staged.items():
                sub[name] = src.block(p) if isinstance(src, _HostPartitions) else src
            out, overflows = fn(sub)
            _check_flags(overflows, f"{tag} partition")
            _store_add(store, _to_host_rows(out), p)
            del sub, out
        return _concat_host_parts(_store_parts(store), device)
    finally:
        store.close()


def run_grace_join(plan: P.PlanNode, tables: Dict[str, Block],
                   budget_bytes: int, spill_dir: str = "", nthreads: int = 0,
                   mesh=None, fuse_stream_agg: bool = True,
                   info: Optional[dict] = None) -> Block:
    """Run a join-rooted plan whose inputs exceed the device budget: the
    host hash-partitions the keyed base table(s), the whole plan runs
    once per partition, and the reducing wrappers merge the outputs.  A
    build side that fits (3x its bytes within the budget) is replicated
    whole; otherwise both sides co-partition.  ``info``, when given,
    receives the partition count (``pieces``) and the build's staging."""
    from .memory import block_bytes
    from .metrics import METRICS

    if mesh is not None:
        raise NotImplementedError(
            "out-of-core execution over a mesh comes with the distribution "
            "slice of the port")
    spec = grace_spec(plan)
    assert spec is not None, "run_grace_join on a non-graceable plan"
    clone = spec.get("clone_build_scan")
    if clone is not None:
        # the build subtree scans the cloned name, registered as the same
        # table
        join = spec["join"]
        shared = clone[: -len("__grace_build")]
        new_join = P.Join(
            kind=join.kind, probe_keys=list(join.probe_keys),
            build_keys=list(join.build_keys), probe=join.probe,
            build=_clone_scan(join.build, shared, clone),
            unique_build=join.unique_build,
            output_capacity=join.output_capacity)
        plan = _rewrap(spec["wrappers"], new_join)
        tables = dict(tables)
        tables[clone] = tables[shared]
        spec = dict(spec, join=new_join)
    probe_b = tables[spec["probe_table"]]
    build_b = tables[spec["build_table"]]
    big = block_bytes(probe_b) + block_bytes(build_b)
    hp = _host_key_hash(probe_b, spec["probe_cols"])
    # widening P (the restore-round analog: host hashing is cheap, so
    # recursion collapses into more partitions); identical-key skew is
    # irreducible and surfaces as an overflow
    P_ = _partition_count(big, budget_bytes, hp,
                          probe_b.capacity + build_b.capacity)
    pid_probe = (hp % np.uint64(P_)).astype(np.int64)
    counts = np.bincount(pid_probe, minlength=P_)
    cap_p = int(-(-(counts.max()) // 8192) * 8192) or 8192
    staged: Dict[str, object] = {
        spec["probe_table"]: _HostPartitions(probe_b, pid_probe, P_, cap_p)}

    replicate_build = (spec["join"].kind in _NO_BUILD_TAIL
                       and block_bytes(build_b) * 3 <= budget_bytes)
    if replicate_build:
        staged[spec["build_table"]] = build_b
    else:
        hb = _host_key_hash(build_b, spec["build_cols"])
        pid_build = (hb % np.uint64(P_)).astype(np.int64)
        bc = np.bincount(pid_build, minlength=P_)
        cap_b = int(-(-(bc.max()) // 8192) * 8192) or 8192
        staged[spec["build_table"]] = _HostPartitions(build_b, pid_build, P_, cap_b)

    METRICS.counter("ooc_grace_joins_total").inc()
    METRICS.counter("ooc_grace_partitions_total").inc(P_)
    if info is not None:
        info.update(pieces=P_, replicated_build=replicate_build)
    merged = _run_partitions(plan, tables, P_, staged, spill_dir, nthreads,
                             "grace", fuse_stream_agg)
    return _reapply_reducers(spec["wrappers"], merged)


# ---------------------------------------------------------------------------
# group-hash partitioned aggregation (non-decomposable aggregates)
# ---------------------------------------------------------------------------


def groupagg_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection]* Aggregation`` with
    group keys resolving to one base table: partitioning the input by
    group-key hash makes every group partition-local, so any aggregate is
    exact per partition."""
    wrappers = []
    node = plan
    while isinstance(node, _WRAPPERS):
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.Aggregation) or not node.keys:
        return None
    bases = [_resolve_key_base(node.child, k) for k in node.keys]
    if any(b is None for b in bases):
        return None
    if len({t for t, _ in bases}) != 1:
        return None
    if _has_join(node.child) or len(set(_scan_tables(node.child))) != 1:
        return None
    return {"wrappers": wrappers, "agg": node, "table": bases[0][0],
            "cols": [c for _, c in bases]}


def run_groupagg(plan: P.PlanNode, tables: Dict[str, Block],
                 budget_bytes: int, spill_dir: str = "", nthreads: int = 0,
                 fuse_stream_agg: bool = True, info: Optional[dict] = None) -> Block:
    """An aggregation over a table exceeding the device budget: the host
    hash-partitions the base table by group key, the whole plan runs per
    partition, the reducing wrappers re-apply at the end.  ``info``, when
    given, receives the partition count (``pieces``)."""
    from .memory import block_bytes

    spec = groupagg_spec(plan)
    assert spec is not None, "run_groupagg on a non-matching plan"
    base = tables[spec["table"]]
    h = _host_key_hash(base, spec["cols"])
    P_ = _partition_count(block_bytes(base), budget_bytes, h, base.capacity)
    pid = (h % np.uint64(P_)).astype(np.int64)
    counts = np.bincount(pid, minlength=P_)
    cap = int(-(-(counts.max()) // 8192) * 8192) or 8192
    if info is not None:
        info.update(pieces=P_)
    merged = _run_partitions(
        plan, tables, P_, {spec["table"]: _HostPartitions(base, pid, P_, cap)},
        spill_dir, nthreads, "groupagg", fuse_stream_agg)
    return _reapply_reducers(spec["wrappers"], merged)


# ---------------------------------------------------------------------------
# external sort / sliced execution (sort spill analog)
# ---------------------------------------------------------------------------


def sliced_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection]*`` over one base
    table with at least one reducing node: row-sliced runs plus a final
    merge pass are exact."""
    wrappers = []
    node = plan
    reducing = False
    while isinstance(node, _WRAPPERS):
        if isinstance(node, (P.TopN, P.Sort, P.Limit)):
            reducing = True
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.TableScan) or not reducing:
        return None
    return {"wrappers": wrappers, "table": node.table}


def run_sliced(plan: P.PlanNode, tables: Dict[str, Block], chunk_rows: int,
               spill_dir: str = "", nthreads: int = 0,
               info: Optional[dict] = None) -> Block:
    """External sort/top-N: per-chunk runs, concatenated on the host, one
    merge pass.  ``info``, when given, receives the run count
    (``pieces``)."""
    from .cancel import checkpoint

    spec = sliced_spec(plan)
    assert spec is not None
    base = tables[spec["table"]]
    device = base.device
    n = base.capacity
    fn = compile_fragment(plan)
    store = _part_store(spill_dir, "sort", nthreads)
    start = 0
    run_no = 0
    try:
        while start < n:
            checkpoint()
            rows = min(chunk_rows, n - start)
            sub = dict(tables)
            sub[spec["table"]] = _padded_slice(base, start, rows, chunk_rows)
            out, overflows = fn(sub)
            _check_flags(overflows, "sliced run")
            _store_add(store, _to_host_rows(out), run_no)
            del sub, out
            start += rows
            run_no += 1
        merged = _concat_host_parts(_store_parts(store), device)
    finally:
        store.close()
    if info is not None:
        info.update(pieces=run_no)
    return _reapply_reducers(spec["wrappers"], merged)


__all__ = [
    "run_chunked_aggregate", "chunkable",
    "run_grace_join", "grace_spec",
    "run_groupagg", "groupagg_spec",
    "run_sliced", "sliced_spec",
]
