"""Multi-host SPMD execution: jax.distributed + a global (data, shard)
mesh spanning processes.

The reference has NO inter-node backend (SURVEY §5.8: single-node
pthreads; cross-phase exchange is temp files on shared disk).  The
BASELINE ladder's config 5 demands >=80% reads/s scaling from 1 to 4
hosts.  This module is the device design for that rung:

- `jax.distributed.initialize` wires the process group (one process per
  host; coordinator, process count and process id are passed
  explicitly).
- The GLOBAL mesh maps `shard` (index planes) WITHIN a host — the hit
  all-gather of `sharded._gathered_find` rides ICI — and `data` (read
  batches) ACROSS hosts, which crosses DCN but carries ZERO collective
  traffic during alignment: data rows never communicate (the only
  cross-data reduction is the O(10)-scalar stats psum).
- Per-host input feed: process p contributes global batch k*P + p of
  step k — every host parses/holds only one batch at a time, never the
  whole run (workflow/align.py feed striping).  Real deployments give
  each host its own lane/tile shard (the flowcell layout is already
  per-lane); the modulo stripe is the layout-free fallback.
- Output: every host converts/bins ITS rows, writing bin chunk files
  named by GLOBAL batch number to the shared temp directory (the
  reference's own cross-phase exchange medium).  After a device
  barrier, host 0 runs the Build phase over all chunks — global batch
  numbering makes the record order byte-identical to a single-process
  run.

Why `data` is the cross-host axis: per 32k-read global batch the
shard-axis hit all-gather moves ~26 MB per host (sharded.py), which the
links inside a host carry; the data axis moves only psum'd scalar stats
(~100 B) in steady state, so hosts scale independently until the
Build-phase shuffle, which is file-based exactly like the reference.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.fastq import ReadBatch
from .sharded import (ShardedIndexArrays, shard_genome_planes, shard_index,
                      sharded_align_full, sharded_align_paired_full)
from .sharded_aligner import (ShardedAligner, ShardedPairedAligner,
                              _check_rows)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed (idempotent); returns
    (process_id, num_processes).  Callers pass all three explicitly
    (or via ISAAC_TPU_DIST_* env); with none, JAX's own cluster
    detection applies."""
    coordinator = coordinator or os.environ.get("ISAAC_TPU_DIST_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("ISAAC_TPU_DIST_NPROCS", "0")) or None
    if process_id is None:
        pid_env = os.environ.get("ISAAC_TPU_DIST_PROCID")
        process_id = int(pid_env) if pid_env is not None else None
    # probe WITHOUT touching the backend: jax.process_count() would
    # initialize XLA, after which initialize() refuses to run
    try:
        from jax._src.distributed import global_state
        already = getattr(global_state, "client", None) is not None
    except Exception:
        already = False
    if not already and (coordinator or num_processes):
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def make_global_mesh(local_data: int = 1) -> Mesh:
    """(data, shard) mesh over ALL processes' devices with each
    process's devices occupying `local_data` CONTIGUOUS data rows (so a
    host's result rows are one contiguous slice of the global batch).
    shard axis = local_device_count // local_data, always within a host."""
    nproc = jax.process_count()
    n_local = len(jax.local_devices())
    assert n_local % local_data == 0, (n_local, local_data)
    shard = n_local // local_data
    by_proc: dict[int, list] = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, []).append(d)
    rows = []
    for p in range(nproc):
        devs = by_proc[p]
        assert len(devs) == n_local, "uneven device counts per process"
        rows.extend(np.array(devs).reshape(local_data, shard))
    return Mesh(np.array(rows).reshape(nproc * local_data, shard),
                ("data", "shard"))


def _is_multiprocess(mesh: Mesh) -> bool:
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def put_global(mesh: Mesh, spec: P, x) -> jax.Array:
    """Place a host-replicated numpy value onto a (possibly
    multi-process) mesh: every process holds the full value and
    contributes its addressable shards."""
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    if not _is_multiprocess(mesh):
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def place_sharded_global(mesh: Mesh,
                         sharded: ShardedIndexArrays) -> ShardedIndexArrays:
    """place_sharded for multi-process meshes (every host loads the full
    index from disk and contributes its addressable shards)."""
    sh, repl = P("shard"), P()
    return ShardedIndexArrays(
        key_hi=put_global(mesh, sh, sharded.key_hi),
        key_lo=put_global(mesh, sh, sharded.key_lo),
        key_mids=tuple(put_global(mesh, sh, km) for km in sharded.key_mids),
        pos=put_global(mesh, sh, sharded.pos),
        has_neighbors=put_global(mesh, sh, sharded.has_neighbors),
        bucket_starts=put_global(mesh, sh, sharded.bucket_starts),
        n_real=put_global(mesh, sh, sharded.n_real),
        genome=put_global(mesh, repl, sharded.genome),
        genome_packed=put_global(mesh, repl, sharded.genome_packed),
        genome_nbits=put_global(mesh, repl, sharded.genome_nbits),
        contig_starts=put_global(mesh, repl, sharded.contig_starts),
        contig_ends=put_global(mesh, repl, sharded.contig_ends),
    )


def to_global_rows(mesh: Mesh, local: np.ndarray) -> jax.Array:
    """Host-local batch rows -> global array sharded over `data`
    (replicated over `shard`): the standard per-host feed."""
    spec = P("data", *([None] * (local.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.ascontiguousarray(local))


def fetch_local(garr) -> np.ndarray:
    """This host's rows of a data-sharded global array (scalars and
    shard-axis replicas deduplicated by index)."""
    if getattr(garr, "ndim", 0) == 0:
        return np.asarray(garr.addressable_shards[0].data)
    seen: dict[int, np.ndarray] = {}
    for s in garr.addressable_shards:
        k = s.index[0].start or 0
        if k not in seen:
            seen[k] = np.asarray(s.data)
    return np.concatenate([seen[k] for k in sorted(seen)])


def barrier(name: str) -> None:
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def allsum_stats(values: dict) -> dict:
    """Sum small per-host numpy stats across processes (align-phase
    counters -> global totals on every host)."""
    from jax.experimental import multihost_utils
    keys = sorted(values)
    flat = [np.asarray(values[k], np.int64) for k in keys]
    gathered = multihost_utils.process_allgather(flat)
    return {k: np.sum(g, axis=0) for k, g in zip(keys, gathered)}


class _MultihostFetchMixin:
    """Fetch override: the step returns the raw (data-sharded) global
    result dict; each host materializes only its addressable rows.
    (The single-buffer packing of the one-process path buys nothing
    here: addressable-shard fetches are direct host<->device copies.)"""

    def _fetch_result(self, packed, handle):
        assert packed is None
        return {k: fetch_local(v) for k, v in handle.items()}


@dataclasses.dataclass
class MultihostAligner(_MultihostFetchMixin, ShardedAligner):
    """Single-end multi-host driver: ShardedAligner with global-mesh
    input feed + local-rows fetch."""

    @staticmethod
    def create_multihost(index, mesh: Mesh, read_len: int | None = None,
                         cfg=None, genome_sharded: bool = False, **opts
                         ) -> "MultihostAligner":
        from ..aligner import Aligner
        from .sharded_aligner import _base_kwargs
        base = Aligner.create(index, read_len=read_len, cfg=cfg, **opts)
        sharded = place_sharded_global(
            mesh, shard_index(index, mesh.shape["shard"]))
        gs = None
        if genome_sharded:
            from .sharded import GenomeShards
            raw = shard_genome_planes(index, mesh.shape["shard"])
            gs = GenomeShards(*(put_global(mesh, P("shard", None), np.asarray(v))
                                for v in raw))
        al = MultihostAligner(**_base_kwargs(base), mesh=mesh,
                              sharded=sharded, genome_shards=gs)
        fcfg = al.cfg

        def step(sh, b, q, tm, ln, gs_arg):
            # NO candidate-plane compaction: compacted row indices are
            # batch-global, while multihost hosts fetch local rows; and
            # fetching the full planes from addressable shards is a
            # direct copy anyway
            res = sharded_align_full(mesh, sh, b, q, fcfg, tm, ln,
                                     genome_shards=gs_arg)
            return None, res

        al._step = jax.jit(step)
        return al

    def _dispatch(self, batch: ReadBatch):
        import time as _time

        from ..align import clippers
        from ..aligner import _pad_to_seed
        t0 = _time.perf_counter()
        d_local = self.mesh.shape["data"] // jax.process_count()
        _check_rows(batch.bases.shape[0],
                    type("M", (), {"shape": {"data": d_local}})())
        bases = batch.bases.copy()
        quals = batch.quals.copy()
        trims = clippers.adapter_trim_batch(bases, quals, list(self.adapters))
        bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
        ob, oq = _pad_to_seed(batch.bases, batch.quals, self.cfg.seed_len)
        m = self.mesh
        out = self._step(self.sharded, to_global_rows(m, ob),
                         to_global_rows(m, oq),
                         to_global_rows(m, trims.astype(np.int32)),
                         to_global_rows(m, batch.lengths.astype(np.int32)),
                         self.genome_shards)
        self._t("dispatch", _time.perf_counter() - t0)
        return out, bases, quals, trims, batch


@dataclasses.dataclass
class MultihostPairedAligner(_MultihostFetchMixin, ShardedPairedAligner):
    """Paired multi-host driver (in-program rescue, like
    ShardedPairedAligner)."""

    @staticmethod
    def create_multihost(index, mesh: Mesh, read_len: int | None = None,
                         cfg=None, genome_sharded: bool = False, **opts
                         ) -> "MultihostPairedAligner":
        from ..aligner import PairedAligner
        from .sharded_aligner import _base_kwargs
        base = PairedAligner.create(index, read_len=read_len, cfg=cfg, **opts)
        sharded = place_sharded_global(
            mesh, shard_index(index, mesh.shape["shard"]))
        gs = None
        if genome_sharded:
            from .sharded import GenomeShards
            raw = shard_genome_planes(index, mesh.shape["shard"])
            gs = GenomeShards(*(put_global(mesh, P("shard", None), np.asarray(v))
                                for v in raw))
        return MultihostPairedAligner(**_base_kwargs(base), mesh=mesh,
                                      sharded=sharded, genome_shards=gs)

    def _ensure_step(self, tls=None):
        """ShardedPairedAligner._ensure_step with unpacked output (the
        multihost fetch is per-field local shards)."""
        rescue = self._rescue_enabled(tls)
        window = self._rescue_window(tls) if rescue else 0
        key = (window, rescue)
        steps = self.__dict__.setdefault("_steps", {})
        if key in steps:
            self._step = steps[key]
            return self._step
        mesh, cfg = self.mesh, self.cfg
        if rescue and self.genome_shards is not None:
            from .sharded import GS_HALO
            assert window + 512 <= GS_HALO, (window, GS_HALO)

        def step(sh, tls, rtls, b1, q1, b2, q2, tm1, tm2, l1, l2, gs_arg):
            # no compaction — see MultihostAligner.create_multihost
            res = sharded_align_paired_full(mesh, sh, b1, q1, b2, q2, cfg,
                                            tls, tm1, tm2, l1, l2,
                                            rescue=rescue,
                                            genome_shards=gs_arg,
                                            window=window, rescue_tls=rtls)
            return None, res

        self._step = jax.jit(step)
        self._step_key = key
        steps[key] = self._step
        return self._step

    def _dispatch(self, b1: ReadBatch, b2: ReadBatch):
        import time as _time

        from ..align import clippers
        from ..aligner import _pad_to_seed
        t0 = _time.perf_counter()
        btls = self._batch_tls(b1)
        step = self._ensure_step(btls)
        masked = []
        orig = []
        trims = []
        for b in (b1, b2):
            bases = b.bases.copy()
            quals = b.quals.copy()
            t = clippers.adapter_trim_batch(bases, quals, list(self.adapters))
            bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
            masked.append(ReadBatch(b.names, bases, quals, b.lengths))
            orig.append(_pad_to_seed(b.bases, b.quals, self.cfg.seed_len))
            trims.append(t)
        m = self.mesh
        g = lambda x: to_global_rows(m, x)
        out = step(self.sharded, btls, self._rescue_tls(btls),
                   g(orig[0][0]), g(orig[0][1]), g(orig[1][0]), g(orig[1][1]),
                   g(trims[0].astype(np.int32)), g(trims[1].astype(np.int32)),
                   g(b1.lengths.astype(np.int32)),
                   g(b2.lengths.astype(np.int32)), self.genome_shards)
        self._t("dispatch", _time.perf_counter() - t0)
        return out, masked[0], masked[1], trims, (b1, b2)
