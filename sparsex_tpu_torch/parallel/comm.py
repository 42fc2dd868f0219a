"""The collectives of the multi-device executor, and the rank launcher.

Counterpart of the three collectives of ``sparsex_tpu/parallel/shard.py``
(``ShardedCsx._build``):

- :meth:`Comm.ring_window`: the halo window of ``_ring_window``
  (:1379-1389), each rank's x chunk with the ``k`` chunks on either side,
  wrapping round the ring as the ``ppermute`` ring does;
- :meth:`Comm.reduce_scatter_rows`: the ``psum_scatter`` of ``reduce_z``
  (:1344-1363), each rank's symmetric partials over all rows summed onto
  its own row block;
- :meth:`Comm.all_gather_rows`: the row-sharded ``out_specs`` gather and
  trim (:1432-1445), every rank's rows to every rank.

The group's backend decides the transport, and nothing switches it: NCCL
takes the device tensors as they are (one GPU a rank); gloo takes host
tensors, so a rank whose tensors live on a GPU copies them to the host and
back here, and only here (``host_bytes`` counts those copies).  The ring
sends each chunk straight to the ranks within distance ``k`` (one batch of
``dist.batch_isend_irecv``), where the ``ppermute`` ring forwards it ``k``
times; the window is the same.  Its sends and receives go through a group
of their own over the same ranks: gloo's collectives number their
messages in the namespace of the point-to-point tags, so in one group a
collective's message can be taken for a ring chunk.

:func:`run_ranks` starts one process per rank (spawned, a ``FileStore`` in
a temporary directory) and gives each its process group.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

# torch 2.13 renamed the two padded-block collectives (the old names warn)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


class _Window:
    """A ring exchange in flight: :meth:`wait` gives the window."""

    def __init__(self, comm, parts, reqs):
        self._comm, self._parts, self._reqs = comm, parts, reqs

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        if len(self._parts) == 1:
            return self._parts[0]
        return self._comm._back(torch.cat(self._parts), "ring")


class Comm:
    """One rank's collectives over ``group`` for tensors on ``device``.

    ``bytes`` counts, per collective, the bytes this rank hands to the
    transport (the ring's sends, the padded blocks of the two others);
    ``host_bytes`` the copies between the device and the host that a gloo
    group needs for device tensors (``"<op> to host"`` / ``"<op> from
    host"``); ``calls`` the calls."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.backend = str(dist.get_backend(group))
        if self.backend not in ("gloo", "nccl"):
            raise NotImplementedError(
                f"process group backend {self.backend!r}: the collectives "
                "run on 'nccl' (one GPU a rank) or 'gloo' (host tensors)")
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL group needs CUDA tensors, not "
                             f"{device}")
        self.device = device
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        # the ring's own group (every rank of ``group`` makes it here)
        self.ring_group = dist.new_group(
            [self._peer(r) for r in range(self.size)], backend=self.backend,
            use_local_synchronization=True)
        self.through_host = self.backend == "gloo" and device.type != "cpu"
        self.bytes = Counter()
        self.host_bytes = Counter()
        self.calls = Counter()

    # -- transport ----------------------------------------------------
    def _peer(self, r: int) -> int:
        """The global rank of the group's rank ``r`` (what P2P takes)."""
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def _out(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` as the transport takes it: on the host for gloo."""
        t = t.contiguous()
        if self.through_host:
            self.host_bytes[op + " to host"] += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """A transport tensor on the rank's device."""
        if self.through_host:
            self.host_bytes[op + " from host"] += (t.numel()
                                                   * t.element_size())
            return t.to(self.device)
        return t

    # -- the three collectives ------------------------------------------
    def ring_window(self, xloc: torch.Tensor, k: int) -> _Window:
        """Start the exchange of the halo window of this rank's x chunk
        ``xloc`` (rows on the first axis): chunks ``rank - k`` to ``rank +
        k``, modulo the group's size, in that order; ``wait()`` on the
        result gives them concatenated on the rank's device.  The caller
        may compute on ``xloc`` meanwhile."""
        self.calls["ring"] += 1
        if k == 0:
            return _Window(self, [xloc], [])
        n, i = self.size, self.rank
        src = self._out(xloc, "ring")
        parts = [None] * (2 * k + 1)
        parts[k] = src
        ops = []
        for s in range(1, k + 1):
            lp, rp = (i - s) % n, (i + s) % n
            if lp == i:                  # s is a multiple of n: own chunk
                parts[k - s] = parts[k + s] = src
                continue
            parts[k - s] = torch.empty_like(src)
            parts[k + s] = torch.empty_like(src)
            g = self.ring_group
            ops += [dist.P2POp(dist.isend, src, self._peer(rp), g,
                               tag=2 * s),
                    dist.P2POp(dist.irecv, parts[k - s], self._peer(lp), g,
                               tag=2 * s),
                    dist.P2POp(dist.isend, src, self._peer(lp), g,
                               tag=2 * s + 1),
                    dist.P2POp(dist.irecv, parts[k + s], self._peer(rp), g,
                               tag=2 * s + 1)]
            self.bytes["ring"] += 2 * src.numel() * src.element_size()
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return _Window(self, parts, reqs)

    def reduce_scatter_rows(self, z: torch.Tensor, row_start: Sequence[int],
                            nrows_loc: Sequence[int]) -> torch.Tensor:
        """``z`` (rows of the whole matrix on the first axis) summed over
        the group, each rank receiving its own rows: rank j's rows are
        ``[row_start[j], row_start[j] + nrows_loc[j])``.  The blocks are
        padded to the largest, as ``reduce_scatter_tensor`` needs equal
        ones (``reduce_z``)."""
        self.calls["reduce_scatter"] += 1
        n, mr = self.size, max(nrows_loc)
        nrows = row_start[-1] + nrows_loc[-1]
        if _uniform(row_start, nrows_loc, mr):
            zp = z[:nrows]
            if n * mr > nrows:
                zp = torch.cat([zp, zp.new_zeros((n * mr - nrows,)
                                                 + z.shape[1:])])
        else:
            zp = z.new_zeros((n * mr,) + z.shape[1:])
            for j in range(n):
                r0, nl = row_start[j], nrows_loc[j]
                zp[j * mr:j * mr + nl] = z[r0:r0 + nl]
        zp = self._out(zp, "reduce_scatter")
        out = zp.new_empty((mr,) + zp.shape[1:])
        self.bytes["reduce_scatter"] += zp.numel() * zp.element_size()
        _reduce_scatter(out, zp, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(out, "reduce_scatter")[:nrows_loc[self.rank]]

    def all_gather_rows(self, acc: torch.Tensor,
                        gather_idx) -> torch.Tensor:
        """Every rank's rows ``acc`` (first axis) gathered on every rank in
        the matrix's row order: the blocks padded to the largest, gathered
        with ``all_gather_into_tensor`` and taken at ``gather_idx`` (a
        :func:`gather_index`; None where the blocks lie back to back)."""
        self.calls["all_gather"] += 1
        mr = gather_idx.max_rows
        if acc.shape[0] < mr:
            acc = torch.cat([acc, acc.new_zeros((mr - acc.shape[0],)
                                                + acc.shape[1:])])
        src = self._out(acc, "all_gather")
        out = src.new_empty((self.size * mr,) + src.shape[1:])
        self.bytes["all_gather"] += src.numel() * src.element_size()
        _all_gather(out, src, group=self.group)
        out = self._back(out, "all_gather")
        return out[gather_idx.rows] if gather_idx.rows is not None else (
            out[:gather_idx.nrows])

    def reset(self) -> None:
        """Zero the counters."""
        self.bytes.clear()
        self.host_bytes.clear()
        self.calls.clear()


class GatherIndex:
    """Where each row of the matrix lies in the gathered padded blocks:
    ``rows`` (a tensor) or None where the blocks lie back to back (every
    block but the last full), ``nrows`` and ``max_rows``."""

    def __init__(self, row_start, nrows_loc, device):
        self.max_rows = max(nrows_loc)
        self.nrows = row_start[-1] + nrows_loc[-1]
        self.rows = None
        if not _uniform(row_start, nrows_loc, self.max_rows):
            idx = np.zeros(self.nrows, dtype=np.int64)
            for i, (r0, nl) in enumerate(zip(row_start, nrows_loc)):
                idx[r0:r0 + nl] = i * self.max_rows + np.arange(nl)
            self.rows = torch.from_numpy(idx).to(device)


def _uniform(row_start, nrows_loc, mr) -> bool:
    """Whether the row blocks lie back to back from row 0 and each but the
    last holds ``mr`` rows: then padding at the end lays them out."""
    return (row_start[0] == 0
            and all(nl == mr for nl in nrows_loc[:-1])
            and all(row_start[j] == j * mr for j in range(len(row_start))))


def run_ranks(fn: Callable, nprocs: int, args=(), backend: str = "gloo",
              timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, each in a
    process group of ``backend`` over a ``FileStore`` in a temporary
    directory (rank order = the ring's order).  A rank's exception is
    raised here (``torch.multiprocessing.ProcessRaisedException``) and the
    other ranks are stopped.  ``fn`` must be importable by name in a fresh
    interpreter (a module's top-level function)."""
    with tempfile.TemporaryDirectory(prefix="spx_ranks_") as d:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, nprocs, backend, os.path.join(d, "store"),
                              timeout_s, tuple(args)),
            nprocs=nprocs, join=True, start_method="spawn")


def _rank_main(rank, fn, nprocs, backend, store, timeout_s, args):
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


__all__ = ["Comm", "GatherIndex", "run_ranks"]
