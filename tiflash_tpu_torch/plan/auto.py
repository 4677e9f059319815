"""Capacity auto-sizing from catalog statistics and samples.

Counterpart of ``tiflash_tpu/plan/auto.py:40-263``: ``AutoPlanConfig``,
the sampled selectivity and NDV estimates, and ``autosize_plan``, which
fills every unset ``Aggregation.num_slots`` and ``Join.output_capacity``
before a run (the reference's ``QueryRunner`` autosizes every plan; the
overflow-retry loop stays the safety net).  The same plan over the same
tables gets the reference's capacities, node by node.  The head sample
goes through the port's ``Block.take`` and ``ExprEvaluator``.

``distribute_plan`` and the laned-window planner wait for the
distribution slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import nodes as P


@dataclasses.dataclass
class AutoPlanConfig:
    broadcast_threshold_rows: int = 100_000  # build smaller -> broadcast
    skew_aware_joins: bool = False
    runtime_filters: bool = True
    auto_passthrough_agg: bool = False
    join_output_factor: float = 2.0
    selectivity_sample_rows: int = 4096      # 0 disables sampling
    skew_hot_keys: int = 128
    skew_sample_per_device: int = 2048

    @classmethod
    def from_settings(cls, s) -> "AutoPlanConfig":
        """Planner knobs from engine Settings."""
        return cls(
            broadcast_threshold_rows=s.broadcast_threshold_rows,
            skew_aware_joins=s.skew_aware_joins,
            runtime_filters=s.runtime_filters,
            auto_passthrough_agg=s.auto_passthrough_agg,
            join_output_factor=s.join_output_factor,
            selectivity_sample_rows=s.selectivity_sample_rows,
            skew_hot_keys=s.skew_hot_keys,
            skew_sample_per_device=s.skew_sample_per_device,
        )


_SAMPLE_ROWS = 4096


def _sampled_selectivity(cond, scan: P.TableScan, tables,
                         sample_rows: int = _SAMPLE_ROWS,
                         memo: Optional[dict] = None) -> Optional[float]:
    """Evaluate ``cond`` on the first ``sample_rows`` rows of the scanned
    table; the live fraction, or None when not measurable.  Only the
    columns ``cond`` reads are gathered; ``memo`` (one auto-sizing pass)
    answers a repeated (predicate, table) without another evaluation."""
    if tables is None:
        return None
    b = tables.get(scan.table)
    if b is None:
        return None
    key = (id(cond), scan.table, sample_rows)
    if memo is not None and key in memo:
        return memo[key][1]
    try:
        from ..expr.compile import ExprEvaluator
        from .rewrite import _refs

        refs = _refs(cond)
        names = [n for n in b.names if n in refs] or list(b.names[:1])
        k = min(sample_rows, b.capacity)
        head = b.select(names).take(torch.arange(k, dtype=torch.int64, device=b.device))
        c = ExprEvaluator(head).evaluate(cond)
        mask = c.data.to(torch.bool)
        if c.validity is not None:
            mask = mask & c.validity
        frac = float(mask.cpu().numpy().mean())
    except Exception:
        frac = None  # unsampleable predicate: selectivity 1
    if memo is not None:
        memo[key] = (cond, frac)  # the predicate stays alive with its id
    return frac


def _estimate_rows(node: P.PlanNode, stats: Dict[str, int],
                   tables=None, sample_rows: int = _SAMPLE_ROWS,
                   memo: Optional[dict] = None) -> int:
    """Cardinality estimate: catalog row counts at the scans, sampled
    predicate selectivity at Selections (when table data is given)."""
    if isinstance(node, P.TableScan):
        return stats.get(node.table, 1 << 20)
    if isinstance(node, P.Selection):
        base = _estimate_rows(node.child, stats, tables, sample_rows, memo)
        scan = node.child
        while isinstance(scan, (P.Selection, P.Projection)):
            scan = scan.child
        if isinstance(scan, P.TableScan):
            sel = _sampled_selectivity(node.cond, scan, tables, sample_rows, memo)
            if sel is not None:
                return max(1, int(base * sel))
        return base
    if isinstance(node, (P.Join, P.CrossJoin)):
        return max(_estimate_rows(c, stats, tables, sample_rows, memo)
                   for c in node.children)
    if isinstance(node, (P.TopN, P.Limit)):
        return node.limit
    if isinstance(node, P.Aggregation):
        return node.num_slots or _estimate_rows(node.children[0], stats,
                                                tables, sample_rows, memo)
    if not node.children:
        return 1 << 20
    # the reference passes no sample_rows here (its default)
    return max(_estimate_rows(c, stats, tables, memo=memo) for c in node.children)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _ceil_mult(x: int, m: int) -> int:
    return max(m, (int(x) + m - 1) // m * m)


def _sample_ndv(col, n_total: int, sample_rows: int) -> Optional[int]:
    """Two-point NDV extrapolation from the column head: the distinct
    count at k/2 and k rows; still growing, the growth rate extrapolates
    over the remaining rows; saturated, the domain is small.  A string
    column's dictionary and a small stats range answer directly."""
    if col.dtype.is_string and col.dictionary is not None:
        return len(col.dictionary) + 1
    if col.stats is not None:
        lo, hi = int(col.stats[0]), int(col.stats[1])
        dom = hi - lo + 1
        if dom <= 4096:
            return dom + 1
    if col.data.ndim != 1:
        return None
    k = min(sample_rows, n_total)
    if k < 8:
        return n_total
    head = col.data[:k].cpu().numpy()
    nd_half = len(np.unique(head[: k // 2]))
    nd_full = len(np.unique(head))
    growth = (nd_full - nd_half) / max(k - k // 2, 1)
    est = nd_full + growth * max(n_total - k, 0)
    return int(min(max(est, nd_full), n_total))


def autosize_plan(plan: P.PlanNode, tables, cfg: Optional[AutoPlanConfig]
                  = None, settings=None) -> P.PlanNode:
    """Fill every unset Aggregation.num_slots / Join.output_capacity from
    catalog row counts x sampled selectivity x sampled key NDV.  Mutates
    the plan nodes in place (as the retry loop does) and returns the
    plan."""
    cfg = cfg or (AutoPlanConfig.from_settings(settings) if settings
                  else AutoPlanConfig())
    sr = cfg.selectivity_sample_rows or 4096
    stats = {name: blk.capacity for name, blk in (tables or {}).items()}
    memo: dict = {}

    def base_scan(node: P.PlanNode) -> Optional[P.TableScan]:
        while isinstance(node, (P.Selection, P.Projection)):
            node = node.children[0]
        return node if isinstance(node, P.TableScan) else None

    def key_ndv(node: P.PlanNode, keys):
        """(NDV product, exact) of the key columns, resolved against any
        base scan below ``node`` that provides them; ``exact`` when every
        factor is a catalog-proven ``Column.ndv``."""
        est, exact = 1, True
        for kname in keys:
            found, fexact = None, False
            stack = [node]
            while stack:
                cur = stack.pop()
                sc = base_scan(cur)
                if sc is not None and tables and sc.table in tables:
                    blk = tables[sc.table]
                    if kname in blk.names:
                        c = blk[kname]
                        if c.ndv is not None:
                            found, fexact = int(c.ndv), True
                        else:
                            found = _sample_ndv(c, blk.capacity, sr)
                        break
                stack.extend(cur.children)
            if found is None:
                return None, False
            est *= max(found, 1)
            exact = exact and fexact
        return est, exact

    def walk(node: P.PlanNode) -> None:
        for c in node.children:
            walk(c)
        if isinstance(node, P.Aggregation) and node.keys \
                and node.num_slots is None:
            rows = _estimate_rows(node.child, stats, tables, sr, memo)
            ndv, exact = key_ndv(node.child, node.keys)
            if exact and ndv is not None and ndv < rows:
                # a proven group-count bound: ndv + 1 (the NULL group),
                # padded; overflow is impossible
                node.num_slots = _ceil_mult(ndv + 1, 2048)
                return
            est = min(rows, ndv) if ndv is not None else rows
            # 1.25x headroom: pow2ceil rounds up again, and the retry
            # loop is the safety net
            node.num_slots = _pow2ceil(max(256, min(int(est * 1.25) + 1,
                                                    rows)))
        elif isinstance(node, P.Join) \
                and getattr(node, "output_capacity", None) is None \
                and not getattr(node, "unique_build", False):
            probe_rows = _estimate_rows(node.children[0], stats, tables, sr, memo)
            raw_rows = _estimate_rows(node.children[0], stats, None, sr)
            factor = getattr(cfg, "join_output_factor", 2.0)
            # autosizing only shrinks from the default (probe capacity);
            # the retry loop grows
            cand = _pow2ceil(max(256, int(probe_rows * factor)))
            if cand < raw_rows:
                node.output_capacity = cand

    walk(plan)
    return plan


__all__ = ["AutoPlanConfig", "autosize_plan"]
