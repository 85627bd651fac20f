"""High-level host driver: read batches in, SAM records out.

The host side of the reference's MatchSelector/Bam phases: converts the
fixed-shape device result tensors into SAM records (reference analog:
build/FragmentAccessorBamAdapter.hh field mapping)."""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from . import dna
from .align import clippers
from .align import tls as tls_mod
from .align.gapped import BWA, GapScoring
from .align.pairs import TlsStatic, align_paired_batch, rescue_shadows
from .align.pipeline import AlignConfig, IndexArrays, align_batch, \
    align_batch_jit, bucket_params_for, compact_cand_result, \
    default_seed_offsets, genome_has_n_for, mask_tail_device, \
    pack_device_result, prepare_index, result_spec, score_end, \
    unpack_device_result
from .index.build import SeedIndex
from .io import sam
from .io.fastq import ReadBatch
from .utils import tracing


def _accumulate_finder_stats(acc: dict, res: dict) -> None:
    """Tally MatchFinder-style seed outcome scalars out of a result dict.

    Alongside the global totals, a per-batch tally list is kept — one
    entry per batch == one synthesized tile — reproducing the reference's
    per-(iteration, tile) MatchTally (include/alignment/MatchTally.hh)."""
    tally = {}
    for key in ("seeds_no_match", "seeds_too_many", "pass2_reads",
                "pass2_dropped", "cand_dropped"):
        for k in (key, key + "_1", key + "_2"):
            if k in res:
                acc[key] = acc.get(key, 0) + int(res[k])
                tally[key] = tally.get(key, 0) + int(res[k])
    if tally:
        acc.setdefault("tally", []).append(tally)


def _pipelined_results(dispatched, finish_fn, window: int | None = None,
                       workers: int | None = None):
    """Drive (key, pending) pairs through `finish_fn` on `workers`
    threads, `window` batches in flight, yielding (key, result) in order.

    The main thread then only parses + dispatches; the fetch link syncs
    and the gapped/indel/clipper polish passes run on the workers and
    overlap the NEXT batches' device compute — the reference's 3-slot
    load/compute/flush overlap (SelectMatchesTransition.cpp:295-357).
    Several workers overlap the 2-3 fetches a batch makes (result
    buffer + polish kernels) with each other; the worker and window
    counts are tuning values not yet measured on the GPU.
    finish_fn must therefore avoid ordered side effects — stats and
    tracing happen at the (ordered) yield site, see _record_stats."""
    import contextlib
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = int(os.environ.get("ISAAC_TPU_FETCH_WORKERS", "3"))
    if window is None:
        window = int(os.environ.get("ISAAC_TPU_FETCH_WINDOW", "3"))
    ex = ThreadPoolExecutor(max_workers=max(1, workers),
                            thread_name_prefix="isaac-polish")
    done: deque = deque()
    with contextlib.ExitStack() as stack:
        stack.callback(ex.shutdown, wait=True)
        for key, pending in dispatched:
            done.append((key, ex.submit(finish_fn, pending)))
            while len(done) > window:
                k, fut = done.popleft()
                yield k, fut.result()
        while done:
            k, fut = done.popleft()
            yield k, fut.result()


def _pad_to_seed(bases: np.ndarray, quals: np.ndarray, seed_len: int):
    """Widen a batch narrower than the seed with N columns: its seeds all
    carry N and the reads come out unmapped instead of crashing the
    seed-table construction."""
    b, l = bases.shape
    if l >= seed_len:
        return bases, quals
    pb = np.full((b, seed_len), 4, np.uint8)
    pq = np.zeros((b, seed_len), np.uint8)
    pb[:, :l] = bases
    pq[:, :l] = quals
    return pb, pq


def _with_bucket_log2(cfg: AlignConfig, index: SeedIndex) -> AlignConfig:
    """Fill in static index-derived parameters (bucket table + N flag +
    genome length — the latter lets prepare_index skip uploading the raw
    codes plane; index_seed_len routes 64-mer seeds to the 4-word search
    when the index is a true LongKmerType one)."""
    if index.seed_len == 64 and cfg.seed_len != 64:
        raise ValueError(
            f"a 64-mer LongKmerType index only supports 64-mer seeds "
            f"(cfg.seed_len={cfg.seed_len}); build a 16/32-mer index for "
            f"shorter seeds")
    if cfg.index_seed_len is None:
        cfg = dataclasses.replace(cfg, index_seed_len=index.seed_len)
    if cfg.genome_len == 0:
        cfg = dataclasses.replace(cfg,
                                  genome_len=index.genome.total_length)
    if cfg.bucket_log2 is not None:
        return cfg
    width, log2 = bucket_params_for(index)
    return dataclasses.replace(cfg, bucket_width=width, bucket_log2=log2,
                               genome_has_n=genome_has_n_for(index))


@dataclasses.dataclass
class Aligner:
    index: SeedIndex
    arrays: IndexArrays
    cfg: AlignConfig
    # clipping options (reference defaults: AlignOptions.cpp:109,119-120)
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    adapters: tuple[str, ...] = ()
    gap_scoring: GapScoring = BWA
    # reference --gapped-mismatches (=5): ungapped mismatch count that
    # triggers the banded-SW polish (GappedAligner mismatchesCutoff)
    gapped_mismatches: int = 5
    # reference --avoid-smith-waterman (manual.md:272): apply the 7-mer
    # two-confirmed-offsets pre-filter before SW polish
    avoid_smith_waterman: bool = False
    # reference --semialigned-gap-limit (=100; 0 disables): long-indel
    # polish gap bound (SimpleIndelAligner semialignedGapLimit)
    semialigned_gap_limit: int = 100
    # accumulated MatchFinder-style seed stats (statistics lib analog)
    finder_stats: dict = dataclasses.field(default_factory=dict)
    # per-stage wall accumulators (dispatch / fetch / polish seconds) —
    # surfaced by the workflow as stage_seconds for perf forensics
    timings: dict = dataclasses.field(default_factory=dict)

    def _t(self, key: str, dt: float) -> None:
        # called from _pipelined_results worker threads concurrently
        import threading
        lock = self.__dict__.setdefault("_t_lock", threading.Lock())
        with lock:
            self.timings[key] = self.timings.get(key, 0.0) + dt

    def ensure_uploaded(self) -> None:
        """Upload the index planes to HBM if not resident (group-major
        multi-index swapping, parallel/multi_index.py)."""
        if self.arrays is None:
            self.arrays = prepare_index(self.index, upload_codes=False)

    def release_device(self) -> None:
        """Drop the HBM planes (the group-major loop frees one group
        before uploading the next)."""
        self.arrays = None

    @staticmethod
    def create(index: SeedIndex, read_len: int | None = None,
               cfg: AlignConfig | None = None, defer_upload: bool = False,
               **opts) -> "Aligner":
        if cfg is None:
            offsets = default_seed_offsets(read_len or index.seed_len, index.seed_len)
            cfg = AlignConfig(seed_len=index.seed_len, seed_offsets=offsets)
        cfg = _with_bucket_log2(cfg, index)
        al = Aligner(index=index, cfg=cfg,
                     arrays=(None if defer_upload
                             else prepare_index(index, upload_codes=False)),
                     **opts)
        # quality trim + semialigned clip run ON DEVICE inside the fused
        # program (the host numpy passes were the top e2e cost)
        al.cfg = dataclasses.replace(
            cfg, quality_trim_cutoff=al.base_quality_cutoff,
            semialigned_clip=al.clip_semialigned)
        return al

    def _dispatch(self, batch: ReadBatch):
        """Async half: adapter-mask on host, launch the device program
        (quality trimming + semialigned clipping happen on device)."""
        import time as _time
        t0 = _time.perf_counter()
        bases = batch.bases.copy()
        quals = batch.quals.copy()
        trims = clippers.adapter_trim_batch(bases, quals, list(self.adapters))
        bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
        # the device gets ORIGINAL bases (it re-applies the adapter mask
        # from the counts) so it can emit output-oriented SEQ/QUAL; the
        # masked host copies stay for the polish passes
        ob, oq = _pad_to_seed(batch.bases, batch.quals, self.cfg.seed_len)
        out = _single_packed_jit(self.arrays, ob, oq, self.cfg,
                                 trims.astype(np.int32),
                                 batch.lengths.astype(np.int32))
        self._t("dispatch", _time.perf_counter() - t0)
        return out, bases, quals, trims, batch

    def _fetch_result(self, packed, handle) -> dict[str, np.ndarray]:
        """Device result -> host dict.  ONE packed buffer -> ONE
        device-to-host copy per batch.  Multihost subclasses override
        (per-field local-shard fetch)."""
        return unpack_device_result(result_spec(handle),
                                    jax.device_get(packed))

    def _finish(self, pending, gapped: bool = True) -> dict[str, np.ndarray]:
        """Sync half: fetch device results, run host polish passes."""
        import time as _time
        (packed, handle), bases, quals, trims, batch = pending
        t0 = _time.perf_counter()
        res = self._fetch_result(packed, handle)
        t1 = _time.perf_counter()
        self._t("fetch", t1 - t0)
        total_trims = clippers.apply_quality_trim_masks(
            bases, quals, trims, res.pop("qtrim"))
        clippers.apply_masked_tail_cigar(res, "", total_trims, batch.read_len)
        clippers.clip_contig_ends(res, "", self.index.genome, batch.read_len)
        if gapped:
            from .align.gapped import polish_gapped
            from .align.indel import polish_simple_indels
            polish_gapped(self.index, self.cfg, res, bases, quals=quals,
                          gs=self.gap_scoring,
                          trigger=self.gapped_mismatches,
                          avoid_sw=self.avoid_smith_waterman)
            polish_simple_indels(self.index, self.cfg, res, bases, quals=quals,
                                 gs=self.gap_scoring,
                                 trigger=max(6, self.gapped_mismatches + 1),
                                 max_gap=self.semialigned_gap_limit)
        if self.clip_semialigned:
            clippers.apply_semialigned_device(res, "", bases.shape[1])
        self._t("polish", _time.perf_counter() - t1)
        return res

    def _record_stats(self, batch: ReadBatch, res: dict) -> None:
        """Ordered side effects of one finished batch (called at the
        yield site, not on the finish workers — see _pipelined_results)."""
        _accumulate_finder_stats(self.finder_stats, res)
        tracing.trace_batch(batch.names, res)

    def align_batch_arrays(self, batch: ReadBatch,
                           gapped: bool = True) -> dict[str, np.ndarray]:
        """Run the device pipeline; returns host numpy result arrays."""
        res = self._finish(self._dispatch(batch), gapped=gapped)
        self._record_stats(batch, res)
        return res

    def align_results_many(self, batches, gapped: bool = True):
        """Pipelined multi-batch alignment: the main thread dispatches
        batch after batch to the device while worker threads fetch +
        host-polish completed ones (see _pipelined_results).  Yields
        (batch, result arrays) in order."""
        for batch, res in _pipelined_results(
                ((p[4], p) for p in (self._dispatch(b) for b in batches)),
                lambda pending: self._finish(pending, gapped=gapped)):
            self._record_stats(batch, res)
            yield batch, res

    def align_to_sam_many(self, batches, phred_offset: int = 33):
        """Pipelined alignment yielding per-batch SamRecord lists."""
        for batch, res in self.align_results_many(batches):
            yield self._records_from_res(batch, res, phred_offset)

    def align_to_sam(self, batch: ReadBatch, phred_offset: int = 33) -> list[sam.SamRecord]:
        res = self.align_batch_arrays(batch)
        return self._records_from_res(batch, res, phred_offset)

    def _records_from_res(self, batch: ReadBatch, res: dict,
                          phred_offset: int = 33) -> list[sam.SamRecord]:
        genome = self.index.genome
        records: list[sam.SamRecord] = []
        for i, name in enumerate(batch.names):
            if name.startswith("__pad"):
                continue
            length = int(batch.lengths[i])
            bases = batch.bases[i, :length]
            quals = batch.quals[i, :length]
            aligned = bool(res["aligned"][i])
            reverse = bool(res["reverse"][i])
            if aligned and reverse:
                seq = dna.decode(dna.revcomp(bases))
                qual = "".join(chr(int(q) + phred_offset) for q in quals[::-1])
            else:
                seq = dna.decode(bases)
                qual = "".join(chr(int(q) + phred_offset) for q in quals)
            if aligned:
                contig, local = genome.to_local(int(res["start"][i]))
                cigars = res.get("cigar")
                cigar = (cigars[i] if cigars and cigars[i] else f"{length}M")
                rec = sam.SamRecord(
                    qname=name,
                    flag=sam.FLAG_REVERSE if reverse else 0,
                    rname=contig,
                    pos=local + 1,
                    mapq=int(res["mapq"][i]),
                    cigar=cigar,
                    seq=seq,
                    qual=qual,
                )
                rec.set_tag("NM", "i", int(res["edit_distance"][i]))
                rec.set_tag("SM", "i", int(res["mapq"][i]))
            else:
                rec = sam.SamRecord(
                    qname=name, flag=sam.FLAG_UNMAPPED, rname="*", pos=0,
                    mapq=0, cigar="*", seq=seq, qual=qual,
                )
            records.append(rec)
        return records


# ---------------------------------------------------------------------------
# Paired-end driver
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg",))
def _single_packed_jit(arrays, bases, quals, cfg, tail_masked, lengths):
    """align_batch + fetch-payload slimming + result packing.

    `bases`/`quals` are the ORIGINAL (un-masked) batch; the adapter tail
    mask is re-applied on device from the counts.  Output orientation is
    NOT computed on device any more: the host already holds the reads and
    re-orients them on the (off-main-thread) convert stage instead of
    fetching ~500 B/read of seq/qual back.  Candidate planes fetch
    compacted to the polish-triggered rows (compact_cand_result).  The
    returned raw dict is never fetched — it only carries shapes/dtypes
    for the host unpack."""
    mb, mq = mask_tail_device(bases, quals, tail_masked)
    res = align_batch(arrays, mb, mq, cfg, tail_masked)
    res = compact_cand_result(res)
    return pack_device_result(res), res


@functools.partial(jax.jit, static_argnames=("cfg",))
def _paired_jit(arrays, b1, q1, b2, q2, cfg, tls, tm1=None, tm2=None):
    return align_paired_batch(arrays, b1, q1, b2, q2, cfg, tls, tm1, tm2)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _paired_packed_jit(arrays, b1, q1, b2, q2, cfg, tls, tm1, tm2, len1, len2):
    """Paired variant of _single_packed_jit (original inputs + on-device
    adapter masking; orientation host-side, candidate planes compacted —
    see _single_packed_jit).  `tls` is a TRACED pytree of int32 scalars —
    learned-model changes never recompile (the round-3 static-arg design
    cost ~100 s of recompile per run)."""
    mb1, mq1 = mask_tail_device(b1, q1, tm1)
    mb2, mq2 = mask_tail_device(b2, q2, tm2)
    res = align_paired_batch(arrays, mb1, mq1, mb2, mq2, cfg, tls, tm1, tm2)
    for sfx in ("_1", "_2"):
        res = compact_cand_result(res, sfx)
    return pack_device_result(res), res


@functools.partial(jax.jit, static_argnames=("cfg",))
def _ends_summary_jit(arrays, b1, q1, b2, q2, cfg):
    """Slot-0 candidate summaries of both ends for host-side TLS learning."""
    out = {}
    for suffix, (b, q) in (("_1", (b1, q1)), ("_2", (b2, q2))):
        end = score_end(arrays, cfg, b, q)
        out["n" + suffix] = end["num_candidates"]
        out["start" + suffix] = end["start"][:, 0]
        out["rev" + suffix] = end["orient"][:, 0] == 1
    return out


@functools.partial(
    jax.jit, static_argnames=("cfg", "orphan_read_index", "read_lengths",
                              "window"))
def _rescue_jit(arrays, cfg, tls, orphan_read_index, read_lengths,
                orphan_start, orphan_rev, shadow_bases, shadow_quals, window):
    res = rescue_shadows(arrays, cfg, tls, orphan_read_index, read_lengths,
                         orphan_start, orphan_rev, shadow_bases, shadow_quals,
                         window)
    return pack_device_result(res), res


@dataclasses.dataclass
class PairedAligner:
    """Paired-end alignment with TLS learning and shadow rescue.

    Reference analog: MatchSelector::determineTemplateLength +
    TemplateBuilder::buildTemplate (SURVEY.md §3.3).  Workflow:
    `learn_tls()` over representative batches first (or set `tls`
    directly), then `align_to_sam(batch1, batch2)`.
    """

    index: SeedIndex
    arrays: IndexArrays
    cfg: AlignConfig
    tls: TlsStatic = dataclasses.field(default_factory=TlsStatic)
    # rows per rescue kernel call: sized so one call covers a
    # typical batch's shadows (one call and one fetch per site)
    rescue_capacity: int = 2048
    max_rescue_window: int = 4096   # skip rescue when TLS window exceeds this
    # reference --shadow-scan-range (=-1): -1 scans the full template
    # min..max window; >=0 scans median +- range (manual.md:524-527)
    shadow_scan_range: int = -1
    # reference --gapped-mismatches / --semialigned-gap-limit /
    # --avoid-smith-waterman (see Aligner)
    gapped_mismatches: int = 5
    semialigned_gap_limit: int = 100
    avoid_smith_waterman: bool = False
    # clipping options (reference defaults: AlignOptions.cpp:109,119-120)
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    clip_overlapping: bool = True
    adapters: tuple[str, ...] = ()
    gap_scoring: GapScoring = BWA
    # reference --bam-pessimistic-mapq (manual.md:279)
    pessimistic_mapq: bool = False
    finder_stats: dict = dataclasses.field(default_factory=dict)
    # per-stage wall accumulators (see Aligner.timings)
    timings: dict = dataclasses.field(default_factory=dict)

    def _t(self, key: str, dt: float) -> None:
        # called from _pipelined_results worker threads concurrently
        import threading
        lock = self.__dict__.setdefault("_t_lock", threading.Lock())
        with lock:
            self.timings[key] = self.timings.get(key, 0.0) + dt

    ensure_uploaded = Aligner.ensure_uploaded
    release_device = Aligner.release_device

    @staticmethod
    def create(index: SeedIndex, read_len: int | None = None,
               cfg: AlignConfig | None = None, defer_upload: bool = False,
               **opts) -> "PairedAligner":
        if cfg is None:
            offsets = default_seed_offsets(read_len or index.seed_len, index.seed_len)
            cfg = AlignConfig(seed_len=index.seed_len, seed_offsets=offsets)
        cfg = _with_bucket_log2(cfg, index)
        al = PairedAligner(index=index,
                           arrays=(None if defer_upload
                                   else prepare_index(index,
                                                      upload_codes=False)),
                           cfg=cfg,
                           **opts)
        # quality trim + semialigned clip run ON DEVICE inside the fused
        # program (host numpy passes were the top e2e cost); rescued
        # shadows get a host-side semialigned pass (they were unaligned
        # when the device clip ran)
        al.cfg = dataclasses.replace(
            cfg, quality_trim_cutoff=al.base_quality_cutoff,
            semialigned_clip=al.clip_semialigned)
        return al

    # -- TLS learning -------------------------------------------------------

    def learn_tls(self, batches: list[tuple[ReadBatch, ReadBatch]]) -> TlsStatic:
        """Learn template-length statistics from uniquely-aligning pairs
        (TemplateLengthDistribution::addTemplate semantics)."""
        learner = tls_mod.TemplateLengthLearner()
        offsets = self.index.genome.contig_offsets
        for b1, b2 in batches:
            out = _ends_summary_jit(self.arrays, b1.bases, b1.quals,
                                    b2.bases, b2.quals, self.cfg)
            out = jax.device_get(out)
            n1 = out["n_1"]; n2 = out["n_2"]
            s1 = out["start_1"]; s2 = out["start_2"]
            r1 = out["rev_1"]; r2 = out["rev_2"]
            cid1 = np.searchsorted(offsets, s1, side="right") - 1
            cid2 = np.searchsorted(offsets, s2, side="right") - 1
            use = (n1 == 1) & (n2 == 1) & (cid1 == cid2)
            learner.add_batch(s1, r1, b1.read_len, s2, r2, b2.read_len, use)
        stats = learner.finalize()
        self.tls = TlsStatic.from_stats(stats)
        return self.tls

    # -- alignment ----------------------------------------------------------

    def _dispatch(self, b1: ReadBatch, b2: ReadBatch):
        """Async half: adapter-mask both ends on host, launch the device
        program (quality trim + semialigned clip happen on device)."""
        import time as _time
        t0 = _time.perf_counter()
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
        m1, m2 = masked
        # originals go to the device (it re-applies the adapter mask from
        # the counts and emits output-oriented SEQ/QUAL); the masked host
        # copies stay for polish + rescue
        out = _paired_packed_jit(
            self.arrays, orig[0][0], orig[0][1], orig[1][0], orig[1][1],
            self.cfg, self._batch_tls(b1),
            trims[0].astype(np.int32), trims[1].astype(np.int32),
            b1.lengths.astype(np.int32), b2.lengths.astype(np.int32))
        self._t("dispatch", _time.perf_counter() - t0)
        return out, m1, m2, trims, (b1, b2)

    def align_batch_arrays(self, b1: ReadBatch, b2: ReadBatch) -> dict[str, np.ndarray]:
        res = self._finish(self._dispatch(b1, b2))
        self._record_stats(b1, b2, res)
        return res

    def align_results_many(self, batches):
        """Pipelined paired alignment over (b1, b2) batches — the main
        thread dispatches while workers fetch + polish (including the
        rescue kernel round-trips; see _pipelined_results).  Yields
        ((b1, b2), result arrays) in order."""
        for (b1, b2), res in _pipelined_results(
                ((p[4], p) for p in (self._dispatch(b1, b2)
                                     for b1, b2 in batches)),
                self._finish):
            self._record_stats(b1, b2, res)
            yield (b1, b2), res

    def align_to_sam_many(self, batches, phred_offset: int = 33):
        """Pipelined paired alignment yielding per-batch SamRecord lists."""
        for (b1, b2), res in self.align_results_many(batches):
            yield self._records_from_res(b1, b2, res, phred_offset)

    def _fetch_result(self, packed, handle) -> dict[str, np.ndarray]:
        """One packed-buffer fetch (see Aligner._fetch_result); the
        unpacked views are writable, so rescue merging can mutate."""
        return unpack_device_result(result_spec(handle),
                                    jax.device_get(packed))

    def _finish(self, pending) -> dict[str, np.ndarray]:
        import time as _time
        (packed, handle), m1, m2, trims, (b1, b2) = pending
        t0 = _time.perf_counter()
        res = self._fetch_result(packed, handle)
        t1 = _time.perf_counter()
        self._t("fetch", t1 - t0)
        total1 = clippers.apply_quality_trim_masks(
            m1.bases, m1.quals, trims[0], res.pop("qtrim_1"))
        total2 = clippers.apply_quality_trim_masks(
            m2.bases, m2.quals, trims[1], res.pop("qtrim_2"))
        rescued1, rescued2 = self._apply_rescue(res, m1, m2)
        clippers.apply_masked_tail_cigar(res, "_1", total1, b1.read_len)
        clippers.apply_masked_tail_cigar(res, "_2", total2, b2.read_len)
        clippers.clip_contig_ends(res, "_1", self.index.genome, b1.read_len)
        clippers.clip_contig_ends(res, "_2", self.index.genome, b2.read_len)
        from .align.gapped import polish_gapped
        from .align.indel import polish_simple_indels
        gs = self.gap_scoring
        trig = self.gapped_mismatches
        itrig = max(6, trig + 1)
        polish_gapped(self.index, self.cfg, res, m1.bases, "_1",
                      quals=m1.quals, gs=gs, trigger=trig,
                      avoid_sw=self.avoid_smith_waterman)
        polish_gapped(self.index, self.cfg, res, m2.bases, "_2",
                      quals=m2.quals, gs=gs, trigger=trig,
                      avoid_sw=self.avoid_smith_waterman)
        polish_simple_indels(self.index, self.cfg, res, m1.bases, "_1",
                             quals=m1.quals, gs=gs, trigger=itrig,
                             max_gap=self.semialigned_gap_limit)
        polish_simple_indels(self.index, self.cfg, res, m2.bases, "_2",
                             quals=m2.quals, gs=gs, trigger=itrig,
                             max_gap=self.semialigned_gap_limit)
        g_codes = self.index.genome.codes
        if self.clip_semialigned:
            # device clip covers rows aligned at device time; rescued
            # shadows get the host pass (they were unaligned on device)
            clippers.apply_semialigned_device(res, "_1", b1.read_len)
            clippers.apply_semialigned_device(res, "_2", b2.read_len)
            if rescued1.any():
                clippers.clip_semialigned(res, "_1", g_codes, m1.bases,
                                          row_mask=rescued1)
            if rescued2.any():
                clippers.clip_semialigned(res, "_2", g_codes, m2.bases,
                                          row_mask=rescued2)
        if self.clip_overlapping:
            clippers.clip_overlapping(res, m1, m2, g_codes)
        self._t("polish", _time.perf_counter() - t1)
        return res

    def _record_stats(self, b1: ReadBatch, b2: ReadBatch, res: dict) -> None:
        """Ordered side effects of one finished pair batch (yield site,
        not the finish workers — see _pipelined_results)."""
        _accumulate_finder_stats(self.finder_stats, res)
        # anomalous-pair accounting (reference MatchSelectorStats tracks
        # nominal vs anomalous alignment models per tile): both ends
        # aligned but no proper pair even after disjoined rescue
        both = res["aligned_1"] & res["aligned_2"]
        self.finder_stats["anomalous_pairs"] = \
            self.finder_stats.get("anomalous_pairs", 0) \
            + int((both & ~res["proper_pair"]).sum())
        n_skip = int(res.get("rescue_skipped_count", 0))
        if n_skip:
            if not self.finder_stats.get("rescue_skipped"):
                tracing.log(
                    f"shadow rescue DISABLED: TLS window "
                    f"{self._rescue_window()} exceeds max_rescue_window "
                    f"{self.max_rescue_window}; orphaned mates stay "
                    f"unaligned", force=True)
            self.finder_stats["rescue_skipped"] = \
                self.finder_stats.get("rescue_skipped", 0) + n_skip
        tracing.trace_batch(b1.names, res, "_1")
        tracing.trace_batch(b2.names, res, "_2")

    def _batch_tls(self, b1) -> TlsStatic:
        """The TLS model for one batch: a per-tile hint riding the batch
        (--per-tile-tls attaches it in the workflow feed — deterministic,
        unlike mutating self.tls mid-pipeline) or the global model."""
        return getattr(b1, "tls_hint", None) or self.tls

    def _rescue_tls(self, tls: TlsStatic | None = None) -> TlsStatic:
        """TLS used for the rescue window: --shadow-scan-range >= 0 clamps
        the scan to median +- range without touching the pairing model."""
        t = tls or self.tls
        if self.shadow_scan_range < 0:
            return t
        return dataclasses.replace(
            t, mate_min=max(t.mate_min, t.median - self.shadow_scan_range),
            mate_max=min(t.mate_max, t.median + self.shadow_scan_range))

    def _rescue_window(self, tls: TlsStatic | None = None) -> int:
        from .align.pairs import quantize_rescue_window
        t = self._rescue_tls(tls)
        w = t.mate_max - t.mate_min + 1
        return quantize_rescue_window(w, self.max_rescue_window)

    def _dispatch_rescue_chunks(self, res, rows, orphan_end, shadow_batch,
                                read_lengths, window, tls: TlsStatic):
        """Enqueue the rescue kernel over `rows` in fixed-capacity chunks;
        returns [(chunk_size, packed, handle), ...] WITHOUT fetching —
        callers dispatch every rescue site first and fetch afterwards, so
        the per-call latency overlaps across the 2-4 sites a paired batch
        needs (shadow x2 + disjoined x2)."""
        cap = self.rescue_capacity
        pend = []
        for lo in range(0, rows.size, cap):
            chunk = rows[lo : lo + cap]
            pad = cap - chunk.size
            rr = np.concatenate([chunk, np.zeros(pad, np.int64)])
            o_start = res[f"start_{orphan_end}"][rr].astype(np.int32)
            o_rev = res[f"reverse_{orphan_end}"][rr]
            sb = shadow_batch.bases[rr]
            sq = shadow_batch.quals[rr]
            packed, handle = _rescue_jit(
                self.arrays, self.cfg, self._rescue_tls(tls), orphan_end - 1,
                read_lengths, o_start, o_rev, sb, sq, window)
            pend.append((chunk.size, packed, handle))
        return pend

    @staticmethod
    def _fetch_rescue_chunks(pend):
        outs = []
        for size, packed, handle in pend:
            out = unpack_device_result(result_spec(handle),
                                       jax.device_get(packed))
            outs.append({k: v[:size] for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def _run_rescue_chunks(self, res, rows, orphan_end, shadow_batch,
                           read_lengths, window, tls: TlsStatic):
        """Run the rescue kernel over `rows` in fixed-capacity chunks;
        returns concatenated per-row output arrays."""
        return self._fetch_rescue_chunks(self._dispatch_rescue_chunks(
            res, rows, orphan_end, shadow_batch, read_lengths, window, tls))

    def _apply_rescue(self, res, b1: ReadBatch, b2: ReadBatch):
        """Shadow + disjoined-template rescue, merged back into the batch
        result dict.

        Shadow rows (one end unaligned): TemplateBuilder::rescueShadow.
        Disjoined rows (both ends aligned, no TLS-compatible pair): the
        reference re-anchors a rescue at EACH end and adopts the best
        rescued template by (summed mismatch score, then summed log
        probability) — buildDisjoinedTemplate, TemplateBuilder.cpp:716-866
        (we anchor at each end's BEST candidate; the reference also tries
        non-best orphan candidates within a probability slack).
        Returns per-end boolean masks of rescued rows (the host
        semialigned clip covers them)."""
        n_rows = res["aligned_1"].shape[0]
        rescued = {1: np.zeros(n_rows, bool), 2: np.zeros(n_rows, bool)}
        tls = self._batch_tls(b1)
        window = self._rescue_window(tls)
        disjoined = res.get("disjoined")
        if disjoined is None:
            disjoined = np.zeros(n_rows, bool)
        if window > self.max_rescue_window:
            # NOT silent: an over-wide TLS window disables rescue for the
            # whole batch — count the stranded shadows into the result so
            # the ORDERED stats site (_record_stats) logs + tallies them
            # (this method runs concurrently on finish workers)
            res["rescue_skipped_count"] = int(
                res["shadow_1"].sum() + res["shadow_2"].sum()
                + disjoined.sum())
            return rescued[1], rescued[2]
        read_lengths = (b1.read_len, b2.read_len)
        # dispatch EVERY rescue site's kernels before fetching any: the
        # 2 shadow directions + 2 disjoined directions otherwise pay the
        # call-and-fetch latency 4x per batch sequentially
        shadow_pend = {}
        for shadow_end, orphan_end in ((1, 2), (2, 1)):
            rows = np.nonzero(res[f"shadow_{shadow_end}"])[0]
            if rows.size == 0:
                continue
            shadow_batch = b1 if shadow_end == 1 else b2
            shadow_pend[shadow_end] = (rows, self._dispatch_rescue_chunks(
                res, rows, orphan_end, shadow_batch, read_lengths,
                window, tls))
        d_rows = np.nonzero(disjoined)[0]
        dis_pend = {}
        if d_rows.size:
            for orphan_end in (1, 2):
                shadow_batch = b1 if (3 - orphan_end) == 1 else b2
                dis_pend[orphan_end] = self._dispatch_rescue_chunks(
                    res, d_rows, orphan_end, shadow_batch, read_lengths,
                    window, tls)

        for shadow_end, (rows, pend) in shadow_pend.items():
            orphan_end = 3 - shadow_end
            out = self._fetch_rescue_chunks(pend)
            hit = self._merge_rescue(res, rows, shadow_end, orphan_end,
                                     out, read_lengths, tls)
            rescued[shadow_end][hit] = True

        if d_rows.size:
            outs = {}
            keys = {}
            for orphan_end in (1, 2):
                o = self._fetch_rescue_chunks(dis_pend[orphan_end])
                outs[orphan_end] = o
                mm_o = res[f"mismatches_{orphan_end}"][d_rows].astype(np.float64)
                lp_o = res[f"log_prob_{orphan_end}"][d_rows].astype(np.float64)
                key = (mm_o + o["mismatches"]) * 1e5 - (lp_o + o["log_prob"])
                keys[orphan_end] = np.where(o["found"], key, np.inf)
            # direction 1 wins ties (the reference's orphan-index scan
            # order with strict improvement)
            use2 = keys[2] < keys[1]
            for orphan_end, sel_dir in ((1, ~use2), (2, use2)):
                o = dict(outs[orphan_end])
                o["found"] = o["found"] & sel_dir
                shadow_end = 3 - orphan_end
                hit = self._merge_rescue(res, d_rows, shadow_end, orphan_end,
                                         o, read_lengths, tls)
                rescued[shadow_end][hit] = True
                disjoined[hit] = False
            res["disjoined"] = disjoined
        return rescued[1], rescued[2]

    def _merge_rescue(self, res, rows, shadow_end, orphan_end, out,
                      read_lengths, tls: TlsStatic | None = None
                      ) -> np.ndarray:
        found = out["found"]
        hit = rows[found]
        if hit.size == 0:
            return hit
        se = f"_{shadow_end}"
        res["aligned" + se][hit] = True
        res["start" + se][hit] = out["start"][found]
        res["reverse" + se][hit] = out["reverse"][found]
        res["mismatches" + se][hit] = out["mismatches"][found]
        res["edit_distance" + se][hit] = out["edit_distance"][found]
        res["log_prob" + se][hit] = out["log_prob"][found]
        res["shadow" + se][hit] = False
        # rescued-pair score: computed in-kernel in log space
        # (pairs.rescue_shadows) so the host and SPMD paths share one
        # implementation bit-for-bit
        score = out["score"][found].astype(np.int64)
        res["frag_score" + se][hit] = score
        res["template_score"][hit] = score
        # pair geometry
        s = (tls or self.tls).to_stats()
        p1 = res["start_1"][hit]; p2 = res["start_2"][hit]
        r1 = res["reverse_1"][hit]; r2 = res["reverse_2"][hit]
        model = tls_mod.alignment_model(p1, r1, p2, r2)
        length = tls_mod.template_length(p1, read_lengths[0], p2, read_lengths[1])
        res["pair_resolved"][hit] = True
        res["proper_pair"][hit] = np.asarray(s.nominal(model, length))
        res["template_length"][hit] = length
        return hit

    # -- SAM ----------------------------------------------------------------

    def align_to_sam(self, b1: ReadBatch, b2: ReadBatch,
                     phred_offset: int = 33) -> list[sam.SamRecord]:
        res = self.align_batch_arrays(b1, b2)
        return self._records_from_res(b1, b2, res, phred_offset)

    def _records_from_res(self, b1: ReadBatch, b2: ReadBatch, res: dict,
                          phred_offset: int = 33) -> list[sam.SamRecord]:
        genome = self.index.genome
        records: list[sam.SamRecord] = []
        for i in range(b1.count):
            name = b1.names[i]
            if name.startswith("__pad"):
                continue
            recs = _pair_records(genome, res, i, name, b1, b2, phred_offset,
                                 self.cfg.mapq_cap,
                                 pessimistic=self.pessimistic_mapq)
            records.extend(recs)
        return records


def _pair_records(genome, res, i, name, b1, b2, phred_offset, mapq_cap,
                  pessimistic: bool = False):
    """Build the two SAM records of one pair (FragmentAccessorBamAdapter
    field mapping, including the proper-pair MAPQ max rule at :250)."""
    from .align.gapped import cigar_stats
    from .align import tls as tls_mod2
    import re as _re

    out = []
    ends = []
    for e, batch in ((1, b1), (2, b2)):
        length = int(batch.lengths[i])
        bases = batch.bases[i, :length]
        quals = batch.quals[i, :length]
        aligned = bool(res[f"aligned_{e}"][i])
        reverse = bool(res[f"reverse_{e}"][i]) if aligned else False
        cigars = res.get(f"cigar_{e}")
        cigar_str = cigars[i] if cigars and cigars[i] else f"{length}M"
        obs_len = length
        if aligned and cigars and cigars[i]:
            parsed = [(int(n), op) for n, op in _re.findall(r"(\d+)([MIDS])", cigar_str)]
            obs_len = cigar_stats(parsed)[0]
        ends.append({
            "aligned": aligned, "reverse": reverse, "length": length,
            "start": int(res[f"start_{e}"][i]) if aligned else -1,
            "frag_score": int(res[f"frag_score_{e}"][i]) if aligned else 0,
            "nm": int(res[f"edit_distance_{e}"][i]) if aligned else 0,
            "bases": bases, "quals": quals,
            "cigar": cigar_str, "obs_len": obs_len,
        })
    proper = bool(res["proper_pair"][i]) and ends[0]["aligned"] and ends[1]["aligned"]
    tscore = int(res["template_score"][i])
    # recompute template length from post-polish positions/observed spans
    tlen_mag = 0
    if ends[0]["aligned"] and ends[1]["aligned"]:
        c0 = genome.contig_of(ends[0]["start"]).index
        c1 = genome.contig_of(ends[1]["start"]).index
        if c0 == c1:
            tlen_mag = int(tls_mod2.template_length(
                ends[0]["start"], ends[0]["obs_len"],
                ends[1]["start"], ends[1]["obs_len"]))

    for e_idx, (e, batch) in enumerate(((1, b1), (2, b2))):
        me = ends[e_idx]
        mate = ends[1 - e_idx]
        flag = sam.FLAG_PAIRED | (sam.FLAG_READ1 if e == 1 else sam.FLAG_READ2)
        if proper:
            flag |= sam.FLAG_PROPER_PAIR
        if not me["aligned"]:
            flag |= sam.FLAG_UNMAPPED
        if not mate["aligned"]:
            flag |= sam.FLAG_MATE_UNMAPPED
        if me["aligned"] and me["reverse"]:
            flag |= sam.FLAG_REVERSE
        if mate["aligned"] and mate["reverse"]:
            flag |= sam.FLAG_MATE_REVERSE

        if me["aligned"] and me["reverse"]:
            seq = dna.decode(dna.revcomp(me["bases"]))
            qual = "".join(chr(int(q) + phred_offset) for q in me["quals"][::-1])
        else:
            seq = dna.decode(me["bases"])
            qual = "".join(chr(int(q) + phred_offset) for q in me["quals"])

        # placement: unmapped reads sit at the mate's position (reference
        # stores shadows next to orphans for sorting, BinSorter semantics)
        if me["aligned"]:
            rname, local = genome.to_local(me["start"])
            pos = local + 1
        elif mate["aligned"]:
            rname, local = genome.to_local(mate["start"])
            pos = local + 1
        else:
            rname, pos = "*", 0

        if mate["aligned"]:
            mate_rname, mate_local = genome.to_local(mate["start"])
            rnext = "=" if rname == mate_rname else mate_rname
            pnext = mate_local + 1
        elif me["aligned"]:
            rnext, pnext = "=", pos
        else:
            rnext, pnext = "*", 0

        tlen = 0
        if me["aligned"] and mate["aligned"] and tlen_mag:
            if me["start"] < mate["start"] or (me["start"] == mate["start"] and e == 1):
                tlen = tlen_mag
            else:
                tlen = -tlen_mag

        def end_mapq(end) -> int:
            if not end["aligned"]:
                return 0
            if proper and tscore >= 0:
                # --bam-pessimistic-mapq: min(SM, AS) instead of max
                # (FragmentAccessorBamAdapter.hh:260, manual.md:279)
                pick = min if pessimistic else max
                return min(mapq_cap, pick(end["frag_score"], tscore))
            return min(mapq_cap, end["frag_score"])

        mapq = end_mapq(me)

        rec = sam.SamRecord(
            qname=name, flag=flag, rname=rname, pos=pos, mapq=mapq,
            cigar=(me["cigar"] if me["aligned"] else "*"),
            rnext=rnext, pnext=pnext, tlen=tlen, seq=seq, qual=qual,
        )
        if me["aligned"]:
            rec.set_tag("NM", "i", me["nm"])
            rec.set_tag("SM", "i", me["frag_score"])
            if proper and tscore >= 0:
                rec.set_tag("AS", "i", tscore)
        if mate["aligned"]:
            # standard mate tags: cigar + mapping quality (samtools MC/MQ);
            # MQ must equal the MAPQ written on the mate's own record
            rec.set_tag("MC", "Z", mate["cigar"])
            rec.set_tag("MQ", "i", end_mapq(mate))
        out.append(rec)
    return out
