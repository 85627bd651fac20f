"""Production SPMD aligner drivers: the workflow surface of sharded.py.

These subclasses keep the whole host half of the pipeline (fetch, polish,
record conversion, binning) from aligner.Aligner/PairedAligner and swap
only the device program: `_dispatch` launches the shard_map SPMD path
(per-shard seed search + ICI all-gather + replicated scoring + in-program
shadow rescue) over a (data, shard) mesh instead of the single-device jit.
Because the SPMD program is the SAME align_batch/align_paired_batch code
reached through the gathered find_fn hook, results match the
single-device path exactly (k-mer-aligned index shards make the gathered
hit lists identical to the unsharded ones).

Reference analog: the reference scales MatchSelector over threads on one
box (MatchSelector.cpp:279-291); the device equivalent is SPMD over the
device mesh (SURVEY.md §5.8), and this module is what `align --devices N`
constructs (workflow/align.py) — round 2 left the SPMD path reachable
only from the dryrun harness.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..align import clippers
from ..align.pipeline import compact_cand_result, pack_device_result
from ..aligner import Aligner, PairedAligner, _pad_to_seed
from ..io.fastq import ReadBatch
from .sharded import (GS_HALO, GenomeShards, ShardedIndexArrays, make_mesh,
                      place_genome_shards, place_sharded, shard_genome_planes,
                      shard_index, sharded_align_full,
                      sharded_align_paired_full)


def _base_kwargs(base) -> dict:
    return {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}


def _check_rows(n: int, mesh) -> None:
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(
            f"batch rows ({n}) must divide the mesh data axis ({d}); "
            f"pick a batch_size that is a multiple of {d}")


@dataclasses.dataclass
class ShardedAligner(Aligner):
    """Single-end SPMD driver.  align_results_many / _finish and every
    host polish pass are inherited; only the launched device program
    differs (and it returns the same packed two-buffer result)."""

    mesh: object = None
    sharded: ShardedIndexArrays = None
    genome_shards: GenomeShards = None
    _step: object = dataclasses.field(default=None, repr=False)

    @staticmethod
    def create_sharded(index, mesh=None, n_devices: int | None = None,
                       read_len: int | None = None, cfg=None,
                       genome_sharded: bool = False, **opts
                       ) -> "ShardedAligner":
        base = Aligner.create(index, read_len=read_len, cfg=cfg, **opts)
        mesh = mesh or make_mesh(n_devices)
        sharded = place_sharded(mesh, shard_index(index, mesh.shape["shard"]))
        gs = None
        if genome_sharded:
            gs = place_genome_shards(
                mesh, shard_genome_planes(index, mesh.shape["shard"]))
        al = ShardedAligner(**_base_kwargs(base), mesh=mesh, sharded=sharded,
                            genome_shards=gs)
        fcfg = al.cfg   # the final cfg (create() folds clip options in)

        def step(sh, b, q, tm, ln, gs_arg):
            res = sharded_align_full(mesh, sh, b, q, fcfg, tm, ln,
                                     genome_shards=gs_arg)
            res = compact_cand_result(res)
            return pack_device_result(res), res

        al._step = jax.jit(step)
        return al

    def _dispatch(self, batch: ReadBatch):
        _check_rows(batch.bases.shape[0], self.mesh)
        bases = batch.bases.copy()
        quals = batch.quals.copy()
        trims = clippers.adapter_trim_batch(bases, quals, list(self.adapters))
        bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
        ob, oq = _pad_to_seed(batch.bases, batch.quals, self.cfg.seed_len)
        out = self._step(self.sharded, ob, oq, trims.astype(np.int32),
                         batch.lengths.astype(np.int32), self.genome_shards)
        return out, bases, quals, trims, batch


@dataclasses.dataclass
class ShardedPairedAligner(PairedAligner):
    """Paired-end SPMD driver with in-program shadow rescue (the host
    rescue pass is skipped: the device program already scanned the full
    TLS window for every shadow row and re-clipped rescued placements)."""

    mesh: object = None
    sharded: ShardedIndexArrays = None
    genome_shards: GenomeShards = None
    _step: object = dataclasses.field(default=None, repr=False)
    _step_key: object = dataclasses.field(default=None, repr=False)

    @staticmethod
    def create_sharded(index, mesh=None, n_devices: int | None = None,
                       read_len: int | None = None, cfg=None,
                       genome_sharded: bool = False, **opts
                       ) -> "ShardedPairedAligner":
        base = PairedAligner.create(index, read_len=read_len, cfg=cfg, **opts)
        mesh = mesh or make_mesh(n_devices)
        sharded = place_sharded(mesh, shard_index(index, mesh.shape["shard"]))
        gs = None
        if genome_sharded:
            gs = place_genome_shards(
                mesh, shard_genome_planes(index, mesh.shape["shard"]))
        return ShardedPairedAligner(**_base_kwargs(base), mesh=mesh,
                                    sharded=sharded, genome_shards=gs)

    def _rescue_enabled(self, tls=None) -> bool:
        return self._rescue_window(tls) <= self.max_rescue_window

    def _ensure_step(self, tls=None):
        """(Re)build the jitted SPMD step only when the SHAPE-setting
        parameters change: the quantized rescue window and the rescue
        on/off switch.  The TLS fields themselves ride through as a
        traced pytree — a new learned model reuses the executable (the
        round-3 design re-jitted on every TLS change)."""
        rescue = self._rescue_enabled(tls)
        window = self._rescue_window(tls) if rescue else 0
        key = (window, rescue)
        steps = self.__dict__.setdefault("_steps", {})
        if key in steps:
            return steps[key]
        mesh, cfg = self.mesh, self.cfg
        if rescue and self.genome_shards is not None:
            # each shard's halo must cover the whole rescue span
            assert window + 512 <= GS_HALO, (window, GS_HALO)

        def step(sh, tls, rtls, b1, q1, b2, q2, tm1, tm2, l1, l2, gs_arg):
            res = sharded_align_paired_full(mesh, sh, b1, q1, b2, q2, cfg,
                                            tls, tm1, tm2, l1, l2,
                                            rescue=rescue,
                                            genome_shards=gs_arg,
                                            window=window, rescue_tls=rtls)
            for sfx in ("_1", "_2"):
                res = compact_cand_result(res, sfx)
            return pack_device_result(res), res

        self._step = jax.jit(step)
        self._step_key = key
        steps[key] = self._step
        return self._step

    def _dispatch(self, b1: ReadBatch, b2: ReadBatch):
        _check_rows(b1.bases.shape[0], self.mesh)
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
        out = step(self.sharded, btls, self._rescue_tls(btls), orig[0][0],
                   orig[0][1], orig[1][0], orig[1][1],
                   trims[0].astype(np.int32), trims[1].astype(np.int32),
                   b1.lengths.astype(np.int32), b2.lengths.astype(np.int32),
                   self.genome_shards)
        return out, masked[0], masked[1], trims, (b1, b2)

    def _apply_rescue(self, res, b1: ReadBatch, b2: ReadBatch):
        """Rescue already ran inside the SPMD program (_rescue_inline),
        including the rescued-row semialigned re-clip — return all-False
        so the host pass is a no-op.  When the TLS window exceeded
        max_rescue_window the device skipped rescue too: count the
        stranded shadows exactly like the host path."""
        n = res["aligned_1"].shape[0]
        if not self._rescue_enabled(self._batch_tls(b1)):
            dis = res.get("disjoined")
            # count into the result — the ordered stats site
            # (_record_stats) logs + tallies; this runs on finish workers
            res["rescue_skipped_count"] = int(
                res["shadow_1"].sum() + res["shadow_2"].sum()
                + (dis.sum() if dis is not None else 0))
        return np.zeros(n, bool), np.zeros(n, bool)
