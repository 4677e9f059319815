"""Multi-process execution over ``torch.distributed``.

Counterpart of ``tiflash_tpu/mpp/multihost.py``.  Role analog: the
reference's multi-node MPP cluster.  The same program runs in every
process; each process holds its local shards, and a mesh's collectives
cross processes through the process group (NCCL between cards by
default; gloo when the caller asks for it and for the CPU), while the
collectives among one process's shards stay those of ``mpp/mesh.py``.

    from tiflash_tpu_torch.mpp.multihost import (global_mesh, init_multihost,
        replicate_result, shard_local_blocks)
    init_multihost("127.0.0.1:29500", num_processes=N, process_id=i)
    mesh = global_mesh(local_shards=2)        # 2 shards on this process's card
    # on the CPU, say so:
    # init_multihost(..., backend="gloo"); global_mesh(2, device="cpu")
    tables = shard_local_blocks(local_blocks, mesh)
    out, flags = compile_distributed(plan, mesh)(tables)
    block = collect_result(replicate_result(out, mesh))

Shard s of process p is global shard ``p * local_shards + s``.  Every
process must hold equally sized local blocks (the SPMD contract).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.block import Block, as_dtype_bits, signed_bits
from .mesh import Mesh
from .runner import AXIS, concat_shards, shard_block


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: Optional[str] = None, **kw) -> None:
    """Join the process group at ``coordinator`` ("host:port") over
    ``backend``, NCCL unless the caller names another (``"gloo"`` for a
    group on the CPU).  Raises when NCCL is asked for and no card is
    visible.  A no-op when already initialized."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: NCCL needs a card and none is visible; "
                           "pass backend=\"gloo\" to run the group on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)


class ProcessMesh(Mesh):
    """A mesh whose shards span the processes of the default group:
    ``devices`` are this process's shards."""

    def __init__(self, devices: Sequence, axis: str = AXIS):
        super().__init__(devices, axis)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.comm_device = (torch.device("cuda", torch.cuda.current_device())
                            if dist.get_backend() == "nccl" else torch.device("cpu"))

    @property
    def size(self) -> int:
        return self.world * self.local_size

    @property
    def offset(self) -> int:
        return self.rank * self.local_size

    def __repr__(self) -> str:
        return f"ProcessMesh({self.world} processes x {self.local_size} shards)"

    def _c(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.comm_device).contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return self._to(t, self.devices[0])

    def _global_stack(self, local: torch.Tensor) -> torch.Tensor:
        c = self._c(local)
        parts = [torch.empty_like(c) for _ in range(self.world)]
        dist.all_gather(parts, c)
        return self._back(torch.cat(parts))

    def _global_cat(self, xs: List[torch.Tensor]) -> torch.Tensor:
        local = self._c(torch.cat(xs) if len(xs) > 1 else xs[0])
        n = torch.tensor([local.shape[0]], dtype=torch.int64, device=self.comm_device)
        ns = [torch.empty_like(n) for _ in range(self.world)]
        dist.all_gather(ns, n)
        lens = [int(x) for x in ns]
        m = max(lens)
        pad = torch.zeros((m - local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        padded = torch.cat([local, pad])
        parts = [torch.empty_like(padded) for _ in range(self.world)]
        dist.all_gather(parts, padded)
        return self._back(torch.cat([p[:k] for p, k in zip(parts, lens)]))

    def _global_reduce(self, local: torch.Tensor, op: str) -> torch.Tensor:
        is_bool = local.dtype == torch.bool
        c = self._c(local.to(torch.int64) if is_bool else local)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        if is_bool and op == "sum":
            rop = dist.ReduceOp.MAX  # a boolean sum is an any
        dist.all_reduce(c, op=rop)
        return self._back(c.to(torch.bool) if is_bool else c)

    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        L, W = self.local_size, self.world
        st = self._c(torch.stack([self._back(b) for b in bufs]))  # (L, P, C, ...)
        rest = tuple(st.shape[2:])
        # (L_src, W, L_dst, ...) -> per destination process (W, L_src, L_dst, ...)
        send = st.reshape((L, W, L) + rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)  # (W_src, L_src, L_dst, ...)
        dist.all_to_all_single(recv, send)
        recv = self._back(recv)
        return [self._to(recv[:, :, j].reshape((W * L,) + rest), d)
                for j, d in enumerate(self.devices)]

    def ragged_all_to_all(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        L, W = self.local_size, self.world
        me = self.rank
        # what each global source sends each global destination (rows)
        sizes = torch.tensor([[p.shape[0] for p in row] for row in parts],
                             dtype=torch.int64, device=self.comm_device)
        S = self._global_stack(sizes).cpu().tolist()  # (P, P)
        send, in_split = [], []
        for q in range(W):
            blob = [parts[i][q * L + j] for j in range(L) for i in range(L)]
            in_split.append(sum(b.shape[0] for b in blob))
            send.extend(self._c(b) for b in blob)
        row_shape = tuple(parts[0][0].shape[1:])
        dtype = parts[0][0].dtype
        send_t = (torch.cat(send) if send else
                  torch.zeros((0,) + row_shape, dtype=dtype, device=self.comm_device))
        out_split = [sum(S[p * L + i][me * L + j] for j in range(L) for i in range(L))
                     for p in range(W)]
        recv = torch.empty((sum(out_split),) + row_shape, dtype=dtype,
                           device=self.comm_device)
        dist.all_to_all_single(recv, send_t, output_split_sizes=out_split,
                               input_split_sizes=in_split)
        recv = self._back(recv)
        # received per source process in (j, i) order: reassemble per j
        pieces: Dict[int, list] = {j: [] for j in range(L)}
        pos = 0
        for p in range(W):
            for j in range(L):
                for i in range(L):
                    k = S[p * L + i][me * L + j]
                    pieces[j].append((p * L + i, recv[pos:pos + k]))
                    pos += k
        return [self._to(torch.cat([t for _, t in sorted(pieces[j], key=lambda x: x[0])]),
                         d) for j, d in enumerate(self.devices)]


def global_mesh(local_shards: int = 1, device=None, axis: str = AXIS) -> ProcessMesh:
    """One flat mesh over every process's ``local_shards`` shards, all of
    a process's shards on its ``device`` (default: its card by rank;
    raises when no card is visible — pass ``device="cpu"`` for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no card is visible; pass device=\"cpu\" "
                               "to place the shards on the CPU")
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return ProcessMesh([torch.device(device)] * local_shards, axis)


def shard_local_blocks(local_blocks: Dict[str, Block],
                       mesh: ProcessMesh) -> Dict[str, List[Block]]:
    """This process's rows of each table split over its local shards (no
    host replication across processes)."""
    local = Mesh(mesh.devices, mesh.axis)
    return {name: shard_block(b, local) for name, b in local_blocks.items()}


def replicate_result(out: Sequence[Block], mesh: Mesh) -> List[Block]:
    """Make a result sharded across processes whole on every process: one
    gather of every shard's rows, in global shard order.  A replicated
    result is returned as it is."""
    if getattr(out, "replicated", False) or not isinstance(mesh, ProcessMesh):
        return list(out)
    local = concat_shards(list(out))
    from ..core.block import Column

    cols = []
    for c in local.columns:
        data = as_dtype_bits(mesh._global_cat([signed_bits(c.data)]), c.data.dtype)
        validity = None if c.validity is None else mesh._global_cat([c.validity])
        cols.append(Column(data, validity, c.dtype, c.dictionary, stats=c.stats,
                           concat_sep=c.concat_sep))
    sel = mesh._global_cat([local.sel_mask()])
    return [Block(names=local.names, columns=tuple(cols), sel=sel)]


__all__ = ["init_multihost", "global_mesh", "shard_local_blocks",
           "replicate_result", "ProcessMesh"]
