"""The checkpointed alignment workflow.

Reference analog: workflow::AlignWorkflow
(src/c++/include/workflow/AlignWorkflow.hh:64-292) — a phase state machine
whose full inter-phase state serializes to Temp/AlignerState after every
completed phase (AlignWorkflowSerialization.hh:23-110), with
--start-from / --stop-at rewind semantics (AlignWorkflow.cpp:532-590).

Phase mapping (the reference's MatchFinder+MatchSelector collapse into
one fused device pipeline here):

    Start -> TlsDone      learn template-length statistics (PE only)
          -> AlignDone    align all batches; records to Temp/aligned.sam
          -> ReportsDone  stats JSON + HTML (MatchSelectorStats analog)
          -> BamDone      coordinate sort + duplicate marking + BAM/bai/md5

State is JSON (AlignerState.json); phase artifacts live in Temp/ so any
phase can re-run from its predecessor's artifacts.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ..align.pairs import TlsStatic
from ..align.pipeline import AlignConfig, default_seed_offsets
from ..aligner import Aligner, PairedAligner
from ..index.build import SeedIndex, build_index
from ..io import sam
from ..io.fasta import read_fasta
from ..io.fastq import ReadBatch, pad_batch, read_fastq

STATES = ("Start", "TlsDone", "AlignDone", "ReportsDone", "BamDone")


#: share of the device's memory that resident index planes may take; the
#: rest holds the batch programs' buffers
PLANE_BUDGET_SHARE = 0.8


def device_plane_budget() -> float:
    """Bytes of index planes that stay resident on the device at once."""
    from ..utils.device import device_bytes
    return PLANE_BUDGET_SHARE * device_bytes()


def _coords_from_names(names: list[str]):
    from .stats_agg import coords_from_names
    return coords_from_names(names)


def parse_tls_override(spec: str) -> TlsStatic:
    """--tls 'min:median:max:lowStdDev:highStdDev:M0:M1' (manual.md:572-575)
    -> the static TLS model (mate window = [min, max], reference
    --mate-drift-range -1 default)."""
    parts = spec.split(":")
    if len(parts) != 7:
        raise ValueError(
            f"--tls {spec!r}: want min:median:max:lowStdDev:highStdDev:M0:M1")
    mn, _median, mx, _lo_sd, _hi_sd, m0, m1 = (int(x) for x in parts)
    if not (0 <= m0 <= 7 and 0 <= m1 <= 7):
        raise ValueError(f"--tls {spec!r}: models must be 0..7 (FFp..RRm)")
    return TlsStatic(min=mn, max=mx, mate_min=mn, mate_max=mx,
                     best0=m0, best1=m1, median=_median)


@dataclasses.dataclass
class WorkflowOptions:
    reference: str                      # FASTA path or saved index directory
    output_dir: str
    fastq1: str | None = None
    fastq2: str | None = None           # paired-end when set
    bam_input: str | None = None        # realign from an existing BAM
    run_folder: str | None = None       # BCL run folder (native Illumina input)
    lanes: tuple[int, ...] | None = None    # BCL lane subset (default: all)
    tiles: tuple[int, ...] | None = None    # BCL tile subset (default: all)
    pf_only: bool = True                # BCL: drop non-pass-filter clusters
    use_bases_mask: str | None = None   # BCL: y/n/i per-cycle mask grammar
    # reference --ignore-missing-bcls/-filters (manual.md:397-400):
    # degrade missing cycle files to N bases / missing filters to all-PF
    ignore_missing_bcls: bool = False
    ignore_missing_filters: bool = False
    seed_len: int = 32
    # per-index address-space cap; FASTA references over this split into
    # contig-group indexes automatically (index/groups.py)
    group_limit: int = 2**31 - 1
    batch_size: int = 4096
    # reference --neighborhood-size-threshold (0 = off, AlignOptions.cpp:96)
    neighborhood_size_threshold: int = 0
    tls_batches: int = 4
    keep_duplicates: bool = True        # mark, don't remove (reference default)
    mark_duplicates: bool = True
    gapped: bool = True
    sample: str = "sample"
    compression_level: int = 1
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    clip_overlapping: bool = True
    adapters: tuple[str, ...] = ()
    # demultiplexing (reference: lib/demultiplexing + BarcodeBamMapping)
    sample_sheet: str | None = None     # CSV with barcode,sample[,project,lane]
    barcode_fastq: str | None = None    # index (I1) FASTQ, synchronized order
    barcode_mismatches: int = 1
    # known-gap realignment in the Build phase (reference --realign-gaps:
    # no | sample | project | all — gap-sharing scope across samples)
    realign_gaps: str = "sample"
    # reference --gap-scoring: bwa | eland | m:mm:go:ge[:me]
    gap_scoring: str = "bwa"
    # reference --seeds: auto | colon-separated offsets ("0:32:64"); a
    # comma-separated per-read list collapses to the first entry (all our
    # reads share geometry)
    seeds: str = "auto"
    # reference --repeat-threshold (align-time, default 10)
    repeat_threshold: int = 10
    # reference --first-pass-seeds (default 1; ignored when --seeds=auto
    # in the reference, honored always here)
    first_pass_seeds: int = 1
    # reference --dodgy-alignment-score: Unaligned | 0-254
    dodgy_alignment_score: str = "0"
    # reference --tls: 'min:median:max:lowStdDev:highStdDev:M0:M1' forces
    # the template-length model instead of learning it
    tls_override: str | None = None
    # reference --mate-drift-range (default -1): when >= 0, shadow rescue
    # scans median +- range instead of the min..max template window
    # (TemplateLengthStatistics.hh:201 setMin/setMax)
    mate_drift_range: int = -1
    # reference --bam-pessimistic-mapq: MAPQ := min(60, min(SM, AS)) for
    # proper pairs instead of min(60, max(SM, AS)) (manual.md:279)
    pessimistic_mapq: bool = False
    # genomic binning threshold: runs larger than this many records split
    # into position bins processed in bounded memory during the Build
    # phase (reference BinIndexMap + Build::sortBinParallel)
    records_per_bin: int = 1_000_000
    # reference --bam-exclude-tags (default ZX,ZY; 'all'/'none' allowed;
    # excludable: AS,BC,NM,OC,RG,SM,ZX,ZY — manual.md:274-275)
    bam_exclude_tags: str = "ZX,ZY"
    # reference --memory-limit (GB, 0 = unlimited): caps the genomic bin
    # size so every Build-phase bin fits the budget (the reference
    # enforces it via ulimit -v + bin admission, bin/isaac-align.cpp:44-50
    # + include/build/Build.hh:163-183; here bins are sized to fit)
    memory_limit: float = 0.0
    # SPMD over an N-device (data, shard) mesh (parallel/sharded_aligner):
    # 0/1 = single device; -1 = all visible devices.  The index shards
    # over the mesh's `shard` axis and batches over `data`; the Build
    # phase routes duplicate marking through the collective
    # (all_to_all + on-device sort) path.
    devices: int = 0
    # with --devices: position-shard the packed genome planes too, so
    # each device holds G/S + halo bases instead of the whole genome
    # (the >HBM whole-genome regime; requires 32-mer seeds)
    shard_genome: bool = False
    # reference --keep-unaligned (=back): discard | front | back placement
    # of clusters where no end aligned (manual.md:199-206,412-418)
    keep_unaligned: str = "back"
    # reference --mapq-threshold (=0): only templates with a mapping
    # quality >= threshold are reported (manual.md:421-424)
    mapq_threshold: int = 0
    # reference --gapped-mismatches (=5) / --semialigned-gap-limit (=100)
    gapped_mismatches: int = 5
    semialigned_gap_limit: int = 100
    # reference --shadow-scan-range (=-1): clamp rescue to median+-range
    shadow_scan_range: int = -1
    # reference --realigned-gaps-per-fragment: max known gaps combined
    # into one realignment choice (we default to 4 = the realigner's
    # internal combination bound; the reference uses the flag for buffer
    # estimation with default 1)
    realigned_gaps_per_fragment: int = 4
    # reference --single-library-samples (=1): dedup across the whole
    # sample; 0 treats each LANE as its own library (manual.md:528-531)
    single_library_samples: bool = True
    # reference --qscore-bin / --qscore-bin-values (manual.md:459-464)
    qscore_bin: bool = False
    qscore_bin_values: str = ("0:0,1:1,2-9:6,10-19:15,20-24:22,25-29:27,"
                              "30-34:33,35-39:37,40-63:40")
    # reference --variable-fastq-read-length (=0): error on ragged FASTQ
    # read lengths unless set (shorter reads then pad with N)
    variable_read_length: bool = False
    # reference --bin-regex (=all): all | unaligned | a regex matched
    # against each aligned bin's "contig:first-last" description
    bin_regex: str = "all"
    # reference --bam-header-tag: extra literal header lines (repeatable)
    bam_header_tags: tuple[str, ...] = ()
    # reference IO-parallelism knobs: --input-parallel-load (prefetch
    # depth of the parse stage) and --output-parallel-save (in-flight
    # window of the ordered convert/serialize stages)
    input_parallel_load: int = 2
    output_parallel_save: int = 2
    # reference --per-tile-tls (=0): recompute template-length statistics
    # per tile instead of one run-global model (manual.md); BCL inputs
    # only — the TLS phase makes one extra pass over the tiles and the
    # per-batch model rides each batch as a hint (deterministic)
    per_tile_tls: bool = False
    # reference --ignore-neighbors (=0, manual.md:403): hits from
    # neighbor-annotated k-mers count as clean anchors anyway
    ignore_neighbors: bool = False
    # reference --ignore-repeats (=0, manual.md:405): repeat-suppressed
    # exact matches don't block the inexact (neighbor) matching pass
    ignore_repeats: bool = False
    # reference --scatter-repeats (=0, manual.md:503): exact-score-tie
    # repeat placements pick by per-read hash, not lowest position
    scatter_repeats: bool = False
    # reference --avoid-smith-waterman (=0, manual.md:272): apply the
    # 7-mer two-confirmed-offsets pre-filter before the SW polish
    avoid_smith_waterman: bool = False
    # reference --realign-dodgy (=0, manual.md:467): also realign reads
    # without an alignment score against gaps found in other reads
    realign_dodgy: bool = False
    # reference --realign-vigorously (=0, manual.md:477): feed the
    # realignment result back into gap harvest and realign again
    realign_vigorously: bool = False
    # reference --cleanup-intermediary (=0, manual.md:329): erase Temp
    # bin chunks once the Build phase consumed them (kills bin-level
    # resume, like the reference)
    cleanup_intermediary: bool = False
    # reference --memory-control (=off, manual.md:429): off | warning |
    # strict — what to do when the bin-budget audit trips
    memory_control: str = "off"
    # reference --allow-empty-flowcells (=0, manual.md:271)
    allow_empty_flowcells: bool = False
    # reference --lane-number-max (=8, manual.md:419): highest lane
    # scanned when --fastq1 names a base-calls DIRECTORY of
    # lane<N>_read<R>.fastq[.gz] files
    lane_number_max: int = 8
    # reference --bam-pu-format (=%F:%L:%B, manual.md:281): RG PU field
    # template (%F flowcell id, %L lane list, %B barcode/sample)
    bam_pu_format: str = "%F:%L:%B"
    # reference --reference-name / --description (manual.md:485,366):
    # BAM header metadata (@CO REFERENCE line / @PG DS tag)
    reference_name: str = "default"
    description: str = ""
    # reference --stats-image-format (=gif, manual.md:545): svg | gif |
    # none ('gif' accepted for compatibility; plots are inline SVG)
    stats_image_format: str = "svg"
    # reference --expected-bgzf-ratio (=1, manual.md:373): assumed BAM
    # compression ratio for Build-phase memory budgeting
    expected_bgzf_ratio: float = 1.0
    # reference --buffer-bins (=1, manual.md:325): RAM write-through
    # cache of bin chunks (disk stays authoritative for resume)
    buffer_bins: bool = True
    # reference --pre-sort-bins (=1, manual.md:457): position-sort each
    # chunk at write time (near-sorted bins sort faster in Build)
    pre_sort_bins: bool = True
    # reference --base-calls-format (manual.md:298): force the input
    # format instead of auto-detection
    base_calls_format: str | None = None
    # reference --clusters-at-a-time (=0, manual.md:339): force the
    # FASTQ/BAM batch size (0 = --batch-size / --memory-limit auto)
    clusters_at_a_time: int = 0
    # reference --tiles (manual.md:564): comma-separated regexes over
    # tile numbers selecting a subset of the flowcell
    tiles_regex: str | None = None
    # -- multi-host SPMD (parallel/multihost.py; no reference analog —
    # the reference is single-node, SURVEY §2.14/§5.8).  When
    # dist_processes > 1 (or ISAAC_TPU_DIST_* env), jax.distributed
    # wires the process group; the mesh spans all hosts' devices with
    # `data` across hosts and `shard` within each host; every process
    # runs the same workflow binary (process 0 writes the BAM)
    dist_coordinator: str | None = None
    dist_processes: int = 0
    dist_process_id: int = -1
    # force fixed equal-span bin boundaries (no distribution sampling);
    # multi-host runs imply this — the flag lets a single-process run
    # reproduce a multi-host run's binning byte-for-byte
    uniform_bins: bool = False

    def qscore_table(self) -> "np.ndarray | None":
        """64-entry quality remap table from --qscore-bin-values."""
        if not self.qscore_bin:
            return None
        import numpy as np
        t = np.arange(64, dtype=np.uint8)
        for part in self.qscore_bin_values.split(","):
            rng, _, val = part.strip().partition(":")
            if not val:
                raise ValueError(f"--qscore-bin-values: bad entry {part!r}")
            a, _, b = rng.partition("-")
            lo_, hi_ = int(a), int(b or a)
            t[lo_ : hi_ + 1] = int(val)
        return t

    def excluded_tags(self) -> frozenset[str]:
        spec = (self.bam_exclude_tags or "none").strip()
        allowed = {"AS", "BC", "NM", "OC", "RG", "SM", "ZX", "ZY"}
        if spec.lower() == "all":
            return frozenset(allowed)
        if spec.lower() == "none":
            return frozenset()
        tags = {t.strip().upper() for t in spec.split(",") if t.strip()}
        bad = tags - allowed
        if bad:
            raise ValueError(
                f"--bam-exclude-tags: unknown tag(s) {sorted(bad)}; "
                f"allowed: all,none,{','.join(sorted(allowed))}")
        return frozenset(tags)


# DistributionBinStore moved to build/storage.py (the output
# subprocess constructs it without importing this jax-heavy module)
from ..build.storage import DistributionBinStore as _DistributionBinStore  # noqa: E402


class AlignWorkflow:
    def __init__(self, opts: WorkflowOptions):
        self.opts = opts
        self.out = Path(opts.output_dir)
        self.temp = self.out / "Temp"
        self.stats_dir = self.out / "Stats"
        for d in (self.out, self.temp, self.stats_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.state = "Start"
        self._reads_cache = None
        self.tls: TlsStatic | None = None
        self._index: list[SeedIndex] | None = None
        self._stats: dict = {}

    # -- state (de)serialization -------------------------------------------

    @property
    def state_file(self) -> Path:
        return self.temp / "AlignerState.json"

    def save_state(self) -> None:
        if self._dist[1] > 1 and self._dist[0] != 0:
            return   # process 0 owns the shared state file
        doc = {"state": self.state, "stats": self._stats}
        if self.tls is not None:
            doc["tls"] = dataclasses.asdict(self.tls)
        by_tile = getattr(self, "tls_by_tile", None)
        if by_tile:
            doc["tls_by_tile"] = {f"{k[0]}:{k[1]}": v
                                  for k, v in by_tile.items()}
        self.state_file.write_text(json.dumps(doc, indent=2))

    def load_state(self) -> None:
        if self.state_file.exists():
            doc = json.loads(self.state_file.read_text())
            self.state = doc["state"]
            self._stats = doc.get("stats", {})
            if "tls" in doc:
                self.tls = TlsStatic(**doc["tls"])
            if "tls_by_tile" in doc:
                self.tls_by_tile = {tuple(k.split(":")): v
                                    for k, v in doc["tls_by_tile"].items()}

    def rewind(self, start_from: str) -> None:
        """Reference AlignWorkflow::rewind — drop back to an earlier state."""
        if start_from not in STATES:
            raise ValueError(f"unknown state {start_from}")
        if STATES.index(start_from) < STATES.index(self.state):
            self.state = start_from

    # -- shared resources ---------------------------------------------------

    def _apply_mate_drift(self) -> None:
        """--mate-drift-range: rescue window = median +- range
        (reference TemplateLengthStatistics setMin/setMax)."""
        d = self.opts.mate_drift_range
        if d >= 0 and self.tls is not None:
            self.tls = dataclasses.replace(
                self.tls, mate_min=self.tls.median - d,
                mate_max=self.tls.median + d)

    @property
    def _dist(self) -> tuple[int, int]:
        """(process_id, num_processes) — initializes jax.distributed on
        first use when multi-host options/env are present."""
        if getattr(self, "_dist_cached", None) is None:
            import os
            o = self.opts
            if o.dist_processes > 1 or os.environ.get("ISAAC_TPU_DIST_NPROCS"):
                from ..parallel.multihost import init_distributed
                self._dist_cached = init_distributed(
                    o.dist_coordinator, o.dist_processes or None,
                    o.dist_process_id if o.dist_process_id >= 0 else None)
            else:
                self._dist_cached = (0, 1)
        return self._dist_cached

    def _mh_mesh(self):
        """The global multi-host (data, shard) mesh (data across hosts,
        shard within each host)."""
        if getattr(self, "_mh_mesh_cached", None) is None:
            from ..parallel.multihost import make_global_mesh
            self._mh_mesh_cached = make_global_mesh(local_data=1)
        return self._mh_mesh_cached

    def _mesh(self):
        """The (data, shard) device mesh when --devices requests SPMD
        (cached); None in single-device mode.  Multi-host runs use
        _mh_mesh instead (this stays None so the Build phase dedups on
        host — process 0 builds alone)."""
        if self._dist[1] > 1:
            return None
        n = self.opts.devices
        if n in (0, 1):
            return None
        if getattr(self, "_mesh_cached", None) is None:
            import jax
            from ..parallel.sharded import make_mesh
            avail = len(jax.devices())
            if n == -1:
                n = avail
            if n > avail:
                raise ValueError(
                    f"--devices {n}: only {avail} devices visible")
            self._mesh_cached = make_mesh(n)
            d = self._mesh_cached.shape["data"]
            if self.opts.batch_size % d:
                self.opts = dataclasses.replace(
                    self.opts, batch_size=-(-self.opts.batch_size // d) * d)
        return self._mesh_cached

    def _load_indexes(self) -> list[SeedIndex]:
        """One index per comma-separated --reference entry (contig-group
        indexes for genomes beyond one index's 2^31-base address space:
        parallel/multi_index.py)."""
        if self._index is None:
            from ..index.groups import is_grouped_reference, load_grouped_indexes
            indexes = []
            for part in str(self.opts.reference).split(","):
                ref = Path(part)
                if ref.is_dir() and is_grouped_reference(ref):
                    # memory-map grouped planes: 8 GRCh38-scale groups
                    # are ~37 GB — pages stream through the page cache
                    # during per-group HBM upload instead of living in
                    # RSS (group-major swapping loads one at a time)
                    indexes.extend(load_grouped_indexes(ref, mmap=True))
                elif ref.is_dir():
                    indexes.append(SeedIndex.load(ref))
                else:
                    genome = read_fasta(ref)
                    from ..index.groups import (split_genome_groups,
                                                subset_genome)
                    groups = split_genome_groups(genome.contigs,
                                                 limit=self.opts.group_limit)
                    # 64-mer seeds search a 32-mer index + extension verify
                    sl = min(self.opts.seed_len, 32)
                    if len(groups) == 1:
                        indexes.append(build_index(genome, seed_len=sl))
                    else:
                        indexes.extend(
                            build_index(subset_genome(genome, names),
                                        seed_len=sl)
                            for names in groups)
            self._index = indexes
        return self._index

    def _load_index(self) -> SeedIndex:
        return self._load_indexes()[0]

    def _genome(self):
        """The (combined) genome for output phases."""
        idxs = self._load_indexes()
        if len(idxs) == 1:
            return idxs[0].genome
        from ..io.fasta import ContigMeta, Genome
        codes = np.concatenate([ix.genome.codes for ix in idxs])
        contigs, off, k = [], 0, 0
        for ix in idxs:
            for c in ix.genome.contigs:
                contigs.append(ContigMeta(index=k, name=c.name,
                                          offset=off + c.offset,
                                          length=c.length, md5=c.md5))
                k += 1
            off += ix.genome.total_length
        return Genome(codes=codes, contigs=contigs)

    @property
    def _paired(self) -> bool:
        if self.opts.run_folder:
            from ..io.bcl import parse_run_info
            info = parse_run_info(Path(self.opts.run_folder))
            return len(info.data_reads) >= 2
        if self.opts.bam_input:
            return self._load_all_reads()[1] is not None
        if self.opts.fastq1 and Path(self.opts.fastq1).is_dir():
            files = self._fastq_lane_files()
            return bool(files) and files[0][1] is not None
        return bool(self.opts.fastq2)

    def _load_all_reads(self):
        if getattr(self, "_reads_cache", None) is None:
            if self.opts.bam_input:
                from ..io.bam_input import reads_from_bam
                self._reads_cache = reads_from_bam(self.opts.bam_input)
            elif self.opts.run_folder:
                from ..io.bcl import load_run_reads
                b1, b2, barcodes = load_run_reads(
                    self.opts.run_folder,
                    lanes=list(self.opts.lanes) if self.opts.lanes else None,
                    tiles=list(self.opts.tiles) if self.opts.tiles else None,
                    pf_only=self.opts.pf_only,
                    use_bases_mask=self.opts.use_bases_mask,
                    ignore_missing_bcls=self.opts.ignore_missing_bcls,
                    ignore_missing_filters=self.opts.ignore_missing_filters)
                self._bcl_barcodes = barcodes
                self._reads_cache = (b1, b2)
            else:
                if not self.opts.fastq1:
                    raise ValueError("need --fastq1, --run-folder or --bam input")
                b1 = read_fastq(self.opts.fastq1)
                b2 = read_fastq(self.opts.fastq2) if self.opts.fastq2 else None
                self._reads_cache = (b1, b2)
        return self._reads_cache

    def _read_batches(self) -> list[tuple[ReadBatch, ReadBatch | None]]:
        b1, b2 = self._load_all_reads()
        if b2 is not None and b1.count != b2.count:
            raise ValueError("fastq1/fastq2 read counts differ")
        bs = self.opts.batch_size
        out = []
        for lo in range(0, b1.count, bs):
            hi = min(lo + bs, b1.count)
            sl1 = ReadBatch(b1.names[lo:hi], b1.bases[lo:hi], b1.quals[lo:hi],
                            b1.lengths[lo:hi])
            sl1 = pad_batch(sl1, bs)
            if b2 is not None:
                sl2 = ReadBatch(b2.names[lo:hi], b2.bases[lo:hi], b2.quals[lo:hi],
                                b2.lengths[lo:hi])
                sl2 = pad_batch(sl2, bs)
            else:
                sl2 = None
            out.append((sl1, sl2))
        return out

    # -- phases -------------------------------------------------------------

    def _phase_tls(self) -> None:
        if not self._paired:
            self.tls = None
            return
        if self.opts.tls_override:
            self.tls = parse_tls_override(self.opts.tls_override)
            self._apply_mate_drift()
            self._stats["tls"] = dataclasses.asdict(self.tls)
            return
        # learn on the largest contig group (TLS is a library property)
        import itertools
        index = max(self._load_indexes(),
                    key=lambda ix: ix.genome.total_length)
        learn = [(b1, b2) for b1, b2, _ in
                 itertools.islice(self._batch_stream(),
                                  self.opts.tls_batches)]
        if not learn:
            # empty input (e.g. a per-barcode sample with zero reads):
            # the align phase handles emptiness; default model
            self.tls = None
            return
        o = self.opts
        from ..align.gapped import GapScoring
        read_len = learn[0][0].read_len
        aligner = PairedAligner.create(
            index, read_len=read_len,
            cfg=self._align_config(read_len, index),
            base_quality_cutoff=o.base_quality_cutoff,
            clip_semialigned=o.clip_semialigned,
            adapters=tuple(o.adapters),
            gap_scoring=GapScoring.parse(o.gap_scoring))
        self.tls = aligner.learn_tls(learn)
        self._apply_mate_drift()
        self._stats["tls"] = dataclasses.asdict(self.tls)
        if o.per_tile_tls and o.run_folder:
            self._learn_per_tile_tls(aligner)

    @staticmethod
    def _tile_key_of(name: str) -> tuple[str, str] | None:
        """(lane, tile) from an Illumina read name, or None."""
        parts = name.split(":")
        return (parts[3], parts[4]) if len(parts) >= 5 else None

    def _learn_per_tile_tls(self, aligner) -> None:
        """--per-tile-tls: one extra pass over the (tile-ordered) BCL
        stream learning a model per tile from its first tls_batches
        batches (reference: MatchSelector::determineTemplateLength runs
        per tile, MatchSelector.cpp:188-256).  Tiles whose model does not
        stabilize fall back to the global model at align time."""
        o = self.opts
        by_tile: dict = {}
        cur = None
        collected: list = []

        def finish(key, batches):
            if key is None or not batches:
                return
            stats = aligner.learn_tls(batches)
            by_tile[key] = dataclasses.asdict(aligner.tls)
            del stats

        for b1, b2, _bc in self._batch_stream():
            key = self._tile_key_of(b1.names[0])
            if key != cur:
                finish(cur, collected)
                cur, collected = key, []
            if len(collected) < o.tls_batches:
                collected.append((b1, b2))
        finish(cur, collected)
        self.tls_by_tile = by_tile
        self._stats["tls_per_tile"] = {f"{k[0]}:{k[1]}": v
                                       for k, v in by_tile.items()}

    def _align_config(self, read_len: int, index: SeedIndex) -> AlignConfig:
        o = self.opts
        seed_len = max(o.seed_len, index.seed_len)
        if seed_len > 32 and index.seed_len not in (32, 64):
            raise ValueError(
                "64-mer seeds need a 32-mer index (extension-verify mode) "
                "or a true 64-mer LongKmerType index")
        if o.seeds == "auto":
            offsets = default_seed_offsets(read_len, seed_len)
        else:
            first = o.seeds.split(",")[0]
            offsets = tuple(int(x) for x in first.split(":"))
        dodgy = o.dodgy_alignment_score
        return AlignConfig(
            seed_len=seed_len,
            seed_offsets=offsets,
            repeat_threshold=o.repeat_threshold,
            max_hits_per_seed=o.repeat_threshold,
            first_pass_seeds=o.first_pass_seeds,
            dodgy_mapq=0 if dodgy == "Unaligned" else int(dodgy),
            dodgy_unaligned=dodgy == "Unaligned",
            neighborhood_size_threshold=o.neighborhood_size_threshold,
            ignore_neighbors=o.ignore_neighbors,
            ignore_repeats=o.ignore_repeats,
            scatter_repeats=o.scatter_repeats)

    def _phase_align(self) -> None:
        """Align all batches and stream columnar records to genomic bins.

        Replaces the reference's MatchFinder+MatchSelector disk handoff
        with a fused device pipeline; the output side reproduces
        BinningFragmentStorage (each batch's records convert to numpy
        columns and append to per-bin chunk files — bounded RAM, no
        per-read Python)."""
        import itertools
        import shutil

        import numpy as np

        from ..build import storage as fstore
        index = self._load_index()
        t0 = time.time()
        pid, nproc = self._dist
        mh = nproc > 1
        mesh = self._mesh()   # may round batch_size up to the data axis
        o = self.opts
        if mh and o.per_tile_tls:
            raise ValueError("--per-tile-tls does not combine with "
                             "multi-host execution yet")
        paired = self._paired
        stream = self._batch_stream()
        first = next(stream, None)
        if first is None:
            if not o.allow_empty_flowcells:
                raise ValueError(
                    "input contains no reads "
                    "(--allow-empty-flowcells accepts this)")
            # --allow-empty-flowcells (manual.md:271): finish the phase
            # with zero records; the Build phase emits a valid empty BAM
            bins_dir = self.temp / "bins"
            store = _DistributionBinStore(
                bins_dir, self._genome().contig_offsets,
                self._genome().total_length, 1, sample_cap=1)
            store.finalize()
            self._bin_cache = store
            self._stats["match_selector"] = {
                "total_reads": 0, "aligned": 0, "perfect": 0,
                "proper_pairs": 0, "mapq_hist": [0] * 61,
                "align_seconds": 0.0}
            return
        stream = itertools.chain([first], stream)
        read_len = first[0].read_len
        from ..align.gapped import GapScoring
        clip_kw = dict(base_quality_cutoff=o.base_quality_cutoff,
                       clip_semialigned=o.clip_semialigned,
                       adapters=tuple(o.adapters),
                       gap_scoring=GapScoring.parse(o.gap_scoring),
                       gapped_mismatches=o.gapped_mismatches,
                       semialigned_gap_limit=o.semialigned_gap_limit,
                       avoid_smith_waterman=o.avoid_smith_waterman)
        cfg = self._align_config(read_len, index)
        genome = self._genome()
        indexes = self._load_indexes()

        rg_names = self._demux_names()
        n_records = self._estimate_total_reads() * (2 if paired else 1)
        records_per_bin = self._records_per_bin(read_len)
        self._stats["records_per_bin"] = records_per_bin
        n_bins = max(1, -(-n_records // records_per_bin))
        bins_dir = self.temp / "bins"
        if mh:
            from ..parallel import multihost as mhmod
            if pid == 0 and bins_dir.exists():
                shutil.rmtree(bins_dir)
            mhmod.barrier("bins_cleared")
        elif bins_dir.exists():
            shutil.rmtree(bins_dir)
        store = _DistributionBinStore(
            bins_dir, genome.contig_offsets, genome.total_length, n_bins,
            sample_cap=max(records_per_bin,
                           4 * o.batch_size * (2 if paired else 1)),
            # multi-host: every host must cut IDENTICAL bin boundaries
            # (uniform equal spans), and the host-local RAM cache cannot
            # serve process 0's Build (it sees only one stripe)
            ram_cache_records=(0 if mh else
                               records_per_bin if o.buffer_bins else 0),
            pre_sort=o.pre_sort_bins, uniform=mh or o.uniform_bins)
        # the Build phase reuses the RAM chunk cache when it runs in this
        # process (resume-from-disk falls back to the files)
        self._bin_cache = store

        stats = {"total_reads": 0, "aligned": 0, "perfect": 0,
                 "proper_pairs": 0, "mapq_hist": np.zeros(61, np.int64)}
        per_tile: dict[tuple[str, str], dict] = {}
        demux_counts = np.zeros(len(rg_names) or 1, np.int64)
        batch_no = [0]   # synthesized tile counter for FASTQ/BAM inputs

        def emit(fb, read_names, n_valid: int, gidx: int) -> None:
            mapped = (fb.flag & sam.FLAG_UNMAPPED) == 0
            stats["total_reads"] += len(fb)
            stats["aligned"] += int(mapped.sum())
            if mapped.any():
                stats["mapq_hist"] += np.bincount(
                    np.minimum(fb.mapq[mapped], 60), minlength=61)
                stats["perfect"] += int((mapped & (fb.nm == 0)).sum())
            first = (fb.flag & sam.FLAG_READ2) == 0
            stats["proper_pairs"] += int(
                (((fb.flag & sam.FLAG_PROPER_PAIR) != 0)
                 & ((fb.flag & sam.FLAG_READ1) != 0)).sum())
            if rg_names:
                np.add.at(demux_counts,
                          np.maximum(fb.rg[first], 0), 1)
            if o.run_folder:
                valid = list(read_names[:n_valid])
                rec_names = np.repeat(np.asarray(valid, dtype="U"),
                                      len(fb) // max(len(valid), 1))
                self._tile_agg(rec_names, fb, mapped, per_tile, rg_names)
            else:
                # FASTQ/BAM inputs: synthesize one tile per batch — the
                # reference synthesizes <=clustersAtATime-cluster tiles
                # for FASTQ and reports the same tile histograms
                # (include/workflow/alignWorkflow/FastqDataSource.hh:41-118)
                self._tile_agg(None, fb, mapped, per_tile, rg_names,
                               synth_tile=("1", f"{gidx:04d}"))
            batch_no[0] += 1
            store.add(fb, seq=gidx)

        # the barcode/name sidecar rides a queue so the pipelined aligner
        # generator stays a plain (b1[, b2]) iterator
        from collections import deque
        sidecar: deque = deque()
        t_host = {"parse": 0.0, "convert": 0.0}

        tls_by_tile = getattr(self, "tls_by_tile", None)

        def feed():
            it = iter(stream)
            gidx = -1
            while True:
                t1 = time.perf_counter()
                nxt = next(it, None)
                t_host["parse"] += time.perf_counter() - t1
                gidx += 1
                if nxt is None:
                    if mh and gidx % nproc and pid >= gidx % nproc:
                        # ragged tail: every process must run the same
                        # number of global SPMD steps — feed one all-pad
                        # batch (contributes zero records)
                        from ..io.fastq import LazyNames, pad_batch
                        empty = pad_batch(ReadBatch(
                            LazyNames(np.zeros((0, 1), np.uint8),
                                      np.zeros(0, np.int32)),
                            np.zeros((0, read_len), np.uint8),
                            np.zeros((0, read_len), np.uint8),
                            np.zeros(0, np.int32)), o.batch_size)
                        sidecar.append((None, empty.names, 0, gidx))
                        yield (empty, empty) if paired else empty
                    return
                if mh and gidx % nproc != pid:
                    continue   # another host's stripe
                b1, b2, bc = nxt
                # keep names columnar/lazy — only the BCL per-tile paths
                # materialize strings (aux_for); FASTQ needs the count
                sidecar.append((bc, b1.names, b1.n_valid, gidx))
                if tls_by_tile and paired:
                    key = self._tile_key_of(b1.names[0])
                    doc = tls_by_tile.get(key)
                    if doc is not None:
                        b1.tls_hint = TlsStatic(**doc)
                yield (b1, b2) if paired else b1

        def aux_for(bc_bases, names, n_valid: int):
            zx = zy = None
            rg = bc = None
            if rg_names:
                rg, bc = self._resolve_rg(bc_bases, n_valid)
            if o.run_folder and not {"ZX", "ZY"} <= o.excluded_tags():
                zx, zy = _coords_from_names(list(names[:n_valid]))
            if rg is None and zx is None:
                return None
            from ..build.storage import AuxColumns
            return AuxColumns(rg=rg, rg_names=rg_names, bc=bc, zx=zx, zy=zy)

        if (mh or mesh is not None) and len(indexes) > 1:
            raise ValueError(
                "--devices SPMD does not combine with contig-group "
                "(multi-index) references yet; use a single-group index")
        if mh:
            from ..parallel.multihost import (MultihostAligner,
                                              MultihostPairedAligner)
            mh_mesh = self._mh_mesh()
            if paired:
                aligner = MultihostPairedAligner.create_multihost(
                    index, mesh=mh_mesh, read_len=read_len, cfg=cfg,
                    genome_sharded=o.shard_genome,
                    clip_overlapping=o.clip_overlapping,
                    pessimistic_mapq=o.pessimistic_mapq,
                    shadow_scan_range=o.shadow_scan_range, **clip_kw)
                if self.tls is not None:
                    aligner.tls = self.tls
            else:
                aligner = MultihostAligner.create_multihost(
                    index, mesh=mh_mesh, read_len=read_len, cfg=cfg,
                    genome_sharded=o.shard_genome, **clip_kw)
        elif mesh is not None:
            from ..parallel.sharded_aligner import (ShardedAligner,
                                                    ShardedPairedAligner)
            if paired:
                aligner = ShardedPairedAligner.create_sharded(
                    index, mesh=mesh, read_len=read_len, cfg=cfg,
                    genome_sharded=o.shard_genome,
                    clip_overlapping=o.clip_overlapping,
                    pessimistic_mapq=o.pessimistic_mapq,
                    shadow_scan_range=o.shadow_scan_range, **clip_kw)
                if self.tls is not None:
                    aligner.tls = self.tls
            else:
                aligner = ShardedAligner.create_sharded(
                    index, mesh=mesh, read_len=read_len, cfg=cfg,
                    genome_sharded=o.shard_genome, **clip_kw)
        elif len(indexes) > 1:
            from ..parallel.multi_index import (MultiIndexAligner,
                                                MultiIndexPairedAligner)
            # beyond-device-memory regime: when the summed group planes
            # exceed the device budget, stream group-major (one group
            # resident at a time, parallel/multi_index._group_major_many)
            budget = device_plane_budget()
            plane_bytes = sum(ix.num_records * 13 * 1.3 for ix in indexes)
            gm = plane_bytes > budget
            if gm:
                from ..utils import tracing
                tracing.log(
                    f"multi-index: {plane_bytes/1e9:.1f} GB of index "
                    f"planes > {budget/1e9:.1f} GB device budget — "
                    f"group-major swapping (one group resident at a "
                    f"time)", force=True)
            if paired:
                aligner = MultiIndexPairedAligner.create(
                    indexes, read_len=read_len, cfg=cfg, group_major=gm,
                    clip_overlapping=o.clip_overlapping,
                    pessimistic_mapq=o.pessimistic_mapq,
                    shadow_scan_range=o.shadow_scan_range, **clip_kw)
                if self.tls is not None:
                    aligner.tls = self.tls
            else:
                aligner = MultiIndexAligner.create(indexes, read_len=read_len,
                                                   cfg=cfg, group_major=gm,
                                                   **clip_kw)
        elif paired:
            import os as _os
            if _os.environ.get("ISAAC_TPU_INLINE_RESCUE", "0") == "1":
                # OPT-IN (measured slower on this fixture even after
                # the rescue compaction: the sharded paired program runs
                # ~2x the plain one at 1 device — 23.5k vs 36.5k
                # reads/s e2e): route single-device paired runs through
                # the SPMD program with in-program compacted rescue.
                # Byte-identical output either way (dryrun_multichip
                # compares the workflow BAMs).
                from ..parallel.sharded import make_mesh
                from ..parallel.sharded_aligner import ShardedPairedAligner
                aligner = ShardedPairedAligner.create_sharded(
                    index, mesh=make_mesh(1, data=1, shard=1),
                    read_len=read_len, cfg=cfg,
                    clip_overlapping=o.clip_overlapping,
                    pessimistic_mapq=o.pessimistic_mapq,
                    shadow_scan_range=o.shadow_scan_range, **clip_kw)
            else:
                aligner = PairedAligner.create(
                    index, read_len=read_len, cfg=cfg,
                    clip_overlapping=o.clip_overlapping,
                    pessimistic_mapq=o.pessimistic_mapq,
                    shadow_scan_range=o.shadow_scan_range, **clip_kw)
            if self.tls is not None:
                aligner.tls = self.tls
        else:
            aligner = Aligner.create(index, read_len=read_len, cfg=cfg,
                                     **clip_kw)
        # one loop for all aligner kinds: every one yields (inputs, res)
        # dicts in concatenated-genome coordinates.  Three host stages
        # overlap (the reference's load/compute/flush thread slots,
        # SelectMatchesTransition.cpp:295-357): input parsing runs 2
        # batches ahead on a prefetch thread, the main thread drives
        # dispatch/fetch/polish, and record conversion + bin writes run
        # on an ordered background stage.
        from ..utils.pipeline import OrderedStage, prefetch_iter

        def convert_emit(inputs, res):
            t1 = time.perf_counter()
            bc_bases, names, n_valid, gidx = sidecar.popleft()
            aux = aux_for(bc_bases, names, n_valid)
            if paired:
                fb = fstore.from_paired_result(
                    genome, inputs[0], inputs[1], res,
                    mapq_cap=aligner.cfg.mapq_cap, aux=aux,
                    pessimistic=o.pessimistic_mapq,
                    mapq_threshold=o.mapq_threshold)
            else:
                fb = fstore.from_single_result(
                    genome, inputs, res, mapq_cap=aligner.cfg.mapq_cap,
                    aux=aux, mapq_threshold=o.mapq_threshold)
            emit(fb, names, n_valid, gidx)
            t_host["convert"] += time.perf_counter() - t1

        from . import output_proc as op
        use_proc = op.enabled() and not mh
        if use_proc:
            # record conversion + binning move to a SECOND PROCESS: on
            # the 2-core host the in-process convert thread and the
            # device-link pump fight for the GIL/cores (output_proc.py)
            setup = dict(
                bins_dir=str(bins_dir),
                contig_offsets=np.asarray(genome.contig_offsets),
                genome_bp=genome.total_length, n_bins=n_bins,
                sample_cap=store.sample_cap, pre_sort=o.pre_sort_bins,
                uniform=bool(o.uniform_bins),
                rg_names=rg_names, mapq_cap=aligner.cfg.mapq_cap,
                pessimistic=o.pessimistic_mapq,
                mapq_threshold=o.mapq_threshold, paired=paired,
                run_folder=bool(o.run_folder),
                want_bc="BC" not in o.excluded_tags(),
                want_zxzy=not {"ZX", "ZY"} <= o.excluded_tags(),
                barcode_mismatches=o.barcode_mismatches,
                specs=self._demux_setup()[0],
                spec_to_name=self._demux_setup()[1],
                unknown=self._demux_setup()[2],
            )
            proc = op.OutputProcess(setup)
            from ..io.fastq import LazyNames

            def submit_proc(inputs, res):
                t1 = time.perf_counter()
                bc_bases, names, n_valid, gidx = sidecar.popleft()
                if not isinstance(names, LazyNames):
                    names = LazyNames.from_list(list(names))
                b1 = inputs[0] if paired else inputs
                b2 = inputs[1] if paired else None
                res2 = {k: v for k, v in res.items()
                        if not k.startswith("cand_")}
                proc.submit((
                    gidx, n_valid, names.mat, names.lens, bc_bases,
                    (b1.bases, b1.quals, b1.lengths),
                    (b2.bases, b2.quals, b2.lengths) if b2 is not None
                    else None, res2))
                t_host["convert"] += time.perf_counter() - t1

            try:
                for inputs, res in aligner.align_results_many(
                        prefetch_iter(feed(),
                                      depth=max(1, o.input_parallel_load))):
                    submit_proc(inputs, res)
            finally:
                out = proc.close()
            for k in ("total_reads", "aligned", "perfect", "proper_pairs"):
                stats[k] += out["stats"][k]
            stats["mapq_hist"] += np.asarray(out["stats"]["mapq_hist"],
                                             np.int64)
            demux_counts += np.asarray(out["demux_counts"], np.int64)
            for k, v in out["per_tile"].items():
                key = (k[0], k[1], k[2], int(k[3]))
                agg = per_tile.setdefault(key, dict.fromkeys(v, 0))
                for ck, cv in v.items():
                    agg[ck] += cv
            # the child owned the bin store; Build re-reads chunk files
            self._bin_cache = None
        else:
            writer = OrderedStage(convert_emit,
                          window=max(1, o.output_parallel_save),
                          name="isaac-convert")
            try:
                for inputs, res in aligner.align_results_many(
                        prefetch_iter(feed(),
                                      depth=max(1, o.input_parallel_load))):
                    writer.submit(inputs, res)
            finally:
                writer.close()
            store.finalize(write_meta=(not mh or pid == 0))
        if mh:
            # global totals on every host; chunks all flushed before the
            # barrier releases process 0 into the Build phase
            from ..parallel.multihost import allsum_stats, barrier
            merged = allsum_stats({k: stats[k] for k in (
                "total_reads", "aligned", "perfect", "proper_pairs",
                "mapq_hist")})
            for k, v in merged.items():
                stats[k] = v if k == "mapq_hist" else int(v)
            demux_counts[:] = allsum_stats(
                {"d": demux_counts})["d"]
            fs = getattr(aligner, "finder_stats", None)
            if fs:
                ints = {k: v for k, v in fs.items() if isinstance(v, int)}
                for k, v in allsum_stats(ints).items():
                    fs[k] = int(v)
                fs.pop("tally", None)   # per-host tally lists don't merge
            barrier("align_done")

        if rg_names:
            counts = {nm: int(c) for nm, c in zip(rg_names, demux_counts) if c}
            self._stats["demultiplexing"] = counts
            if not mh or pid == 0:
                (self.stats_dir / "DemultiplexingStats.json").write_text(
                    json.dumps(counts, indent=2))
        if per_tile:
            # multi-host: per-tile rows cover this host's stripe only
            # (global counters above are allsum-merged)
            stats["tiles"] = [
                {"lane": lane, "tile": tile, "barcode": sample,
                 "read": read, **agg}
                for (lane, tile, sample, read), agg in sorted(per_tile.items())]
        stats["align_seconds"] = round(time.time() - t0, 2)
        t_host.update(getattr(aligner, "timings", {}))
        stats["stage_seconds"] = {k: round(v, 2) for k, v in t_host.items()}
        stats["mapq_hist"] = [int(x) for x in stats["mapq_hist"]]
        for k in ("total_reads", "aligned", "perfect", "proper_pairs"):
            stats[k] = int(stats[k])
        self._stats["match_selector"] = stats
        if getattr(aligner, "finder_stats", None):
            self._stats["match_finder"] = dict(aligner.finder_stats)

    def _pu_field(self, sample_name: str) -> str:
        """--bam-pu-format (manual.md:281): expand %F (flowcell id),
        %L (lane list) and %B (barcode/sample) into the @RG PU field."""
        o = self.opts
        fc = "unknown"
        if o.run_folder:
            from ..io.bcl import parse_run_info
            try:
                fc = parse_run_info(Path(o.run_folder)).flowcell
            except Exception:
                pass
        lanes = ",".join(str(x) for x in o.lanes) if o.lanes else "all"
        return (o.bam_pu_format.replace("%F", fc).replace("%L", lanes)
                .replace("%B", sample_name))

    def _check_base_calls_format(self) -> None:
        """--base-calls-format (manual.md:298): validate the declared
        input format against the provided inputs instead of trusting
        auto-detection."""
        o = self.opts
        fmt = o.base_calls_format
        if not fmt:
            return
        from ..utils.errors import InvalidOptionError
        allowed = ("fastq", "fastq-gz", "bam", "bcl", "bcl-gz", "bcl-bgzf")
        if fmt not in allowed:
            raise InvalidOptionError(
                f"--base-calls-format {fmt!r}: expected one of {allowed}")
        if fmt in ("bcl", "bcl-gz", "bcl-bgzf") and not o.run_folder:
            raise InvalidOptionError(
                f"--base-calls-format {fmt}: needs --run-folder input")
        if fmt == "bam" and not o.bam_input:
            raise InvalidOptionError(
                "--base-calls-format bam: needs --bam input")
        if fmt.startswith("fastq"):
            if not o.fastq1:
                raise InvalidOptionError(
                    f"--base-calls-format {fmt}: needs --fastq1 input")
            if not Path(o.fastq1).is_dir():
                is_gz = open(o.fastq1, "rb").read(2) == b"\x1f\x8b"
                if is_gz != (fmt == "fastq-gz"):
                    raise InvalidOptionError(
                        f"--base-calls-format {fmt}: {o.fastq1} is "
                        f"{'gzipped' if is_gz else 'plain'} FASTQ")

    @staticmethod
    def _tile_agg(names, fb, mapped, per_tile: dict,
                  rg_names: tuple[str, ...], synth_tile=None) -> None:
        from .stats_agg import tile_agg
        tile_agg(names, fb, mapped, per_tile, rg_names,
                 synth_tile=synth_tile)

    def _sample_specs(self):
        from ..demultiplexing.samplesheet import parse_sample_sheet
        return parse_sample_sheet(self.opts.sample_sheet)

    def _demux_setup(self):
        """(specs, spec_index -> sample-name index, unknown idx, rg names);
        cached.  Reference analog: BarcodeBamMapping construction."""
        if getattr(self, "_demux_cache", None) is None:
            if not self.opts.sample_sheet:
                self._demux_cache = (None, None, 0, ())
            else:
                from ..demultiplexing.samplesheet import UNKNOWN_SAMPLE
                specs = self._sample_specs()
                sample_names: list[str] = []
                for sp in specs:
                    if sp.sample not in sample_names:
                        sample_names.append(sp.sample)
                unknown = len(sample_names)
                rg_names = tuple(sample_names) + (UNKNOWN_SAMPLE,)
                spec_to_name = np.full(max(sp.index for sp in specs) + 1,
                                       unknown, np.int32)
                for sp in specs:
                    spec_to_name[sp.index] = sample_names.index(sp.sample)
                self._demux_cache = (specs, spec_to_name, unknown, rg_names)
        return self._demux_cache

    def _demux_names(self) -> tuple[str, ...]:
        return self._demux_setup()[3]

    def _resolve_rg(self, bc_bases, n: int):
        """Per-batch barcode resolution -> (rg column, BC ascii or None)."""
        from .. import dna
        from ..demultiplexing.resolver import resolve_barcodes
        specs, spec_to_name, unknown, _ = self._demux_setup()
        if specs is None:
            return None, None
        if bc_bases is None:
            # no index read: everything lands on the unknown sample
            return np.full(n, unknown, np.int32), None
        bidx = resolve_barcodes(bc_bases, specs, self.opts.barcode_mismatches)
        rg = np.where(bidx >= 0, spec_to_name[np.maximum(bidx, 0)],
                      unknown).astype(np.int32)
        bc = None
        if "BC" not in self.opts.excluded_tags():
            bc = dna.CODE_TO_BASE[np.minimum(bc_bases, 4)]
        return rg, bc

    def _bcl_tile_list(self) -> list[tuple[int, int]]:
        from ..io.bcl import discover_lanes, discover_tiles
        o = self.opts
        run = Path(o.run_folder)
        lanes = list(o.lanes) if o.lanes else discover_lanes(run)
        out = []
        for lane in lanes:
            for tile in (list(o.tiles) if o.tiles
                         else discover_tiles(run, lane)):
                out.append((lane, tile))
        if o.tiles_regex:
            # reference --tiles (manual.md:564): comma-separated regexes
            # fullmatched against the 4-digit tile number
            import re
            pats = [re.compile(p) for p in o.tiles_regex.split(",") if p]
            out = [(lane, tile) for lane, tile in out
                   if any(p.fullmatch(f"{tile:04d}") for p in pats)]
            if not out and not o.allow_empty_flowcells:
                from ..utils.errors import InvalidOptionError
                raise InvalidOptionError(
                    f"--tiles {o.tiles_regex!r} matched no tiles")
        return out

    def _fastq_lane_files(self) -> "list[tuple[str, str | None]]":
        """--fastq1 as a base-calls DIRECTORY: discover
        lane<N>_read<R>.fastq[.gz] pairs for lanes 1..--lane-number-max
        (reference FastqLayout.cpp:45-66 naming + --lane-number-max,
        manual.md:419).  A plain file path returns itself."""
        o = self.opts
        p = Path(o.fastq1)
        if not p.is_dir():
            return [(o.fastq1, o.fastq2)]
        out: list[tuple[str, str | None]] = []
        want = list(o.lanes) if o.lanes else range(1, o.lane_number_max + 1)
        for lane in want:
            for ext in (".fastq", ".fastq.gz"):
                r1 = p / f"lane{lane}_read1{ext}"
                if r1.exists():
                    r2 = p / f"lane{lane}_read2{ext}"
                    out.append((str(r1), str(r2) if r2.exists() else None))
                    break
        if not out and not o.allow_empty_flowcells:
            raise ValueError(
                f"{p}: no lane<N>_read1.fastq[.gz] files for lanes "
                f"1..{o.lane_number_max} (--allow-empty-flowcells accepts)")
        return out

    def _estimate_total_reads(self) -> int:
        """Read count for bin sizing: cluster-count headers for BCL,
        file-size estimate for streamed FASTQ, exact for in-RAM sources
        (only bin granularity depends on it)."""
        o = self.opts
        if o.run_folder:
            from ..io.bcl import peek_tile_cluster_count
            return sum(peek_tile_cluster_count(o.run_folder, lane, tile)
                       for lane, tile in self._bcl_tile_list())
        if o.fastq1 and not o.bam_input:
            from ..io.fastq import estimate_fastq_reads
            return sum(estimate_fastq_reads(r1)
                       for r1, _ in self._fastq_lane_files())
        return self._load_all_reads()[0].count

    def _batch_stream(self):
        """Yield (b1, b2 | None, barcode_bases | None) padded batches
        with input-side postprocessing: --qscore-bin quality remapping
        and the --variable-fastq-read-length uniformity check."""
        o = self.opts
        qtab = o.qscore_table()
        for b1, b2, bc in self._raw_batch_stream():
            for b in (b1, b2):
                if b is None:
                    continue
                if not o.variable_read_length:
                    ln = b.lengths[: b.n_valid]
                    if ln.size and int(ln.min()) != int(ln.max()):
                        raise ValueError(
                            f"variable read lengths ({int(ln.min())}.."
                            f"{int(ln.max())}) in the input; pass "
                            f"--variable-fastq-read-length to accept "
                            f"(shorter reads pad with N)")
                if qtab is not None:
                    np.minimum(b.quals, 63, out=b.quals)
                    b.quals[:] = qtab[b.quals]
            yield b1, b2, bc

    def _raw_batch_stream(self):
        """Yield (b1, b2 | None, barcode_bases | None) padded batches.
        FASTQ inputs stream record by record, BCL run folders tile by
        tile (the reference's RAM-fit tile batching, SeedMemoryManager /
        BclSeedSource); only BAM realignment input stays in RAM.

        A per-barcode sub-workflow injects its demultiplexed stream via
        `_stream_factory` (workflow/per_barcode.py)."""
        inj = getattr(self, "_stream_factory", None)
        if inj is not None:
            yield from inj()
            return
        o = self.opts
        if o.run_folder:
            from ..io.bcl import load_tile, parse_run_info, tile_read_batches
            run = Path(o.run_folder)
            info = parse_run_info(run)
            for lane, tile in self._bcl_tile_list():
                td = load_tile(
                    run, lane, tile, info,
                    use_bases_mask=o.use_bases_mask,
                    ignore_missing_bcls=o.ignore_missing_bcls,
                    ignore_missing_filters=o.ignore_missing_filters)
                batches, bars = tile_read_batches(td, info, o.pf_only)
                if not batches:
                    raise ValueError(f"{run}: no data reads in RunInfo")
                if len(batches) > 2:
                    raise ValueError("more than 2 data reads not supported")
                b1t = batches[0]
                b2t = batches[1] if len(batches) > 1 else None
                bs = o.batch_size
                for lo in range(0, b1t.count, bs):
                    hi = min(lo + bs, b1t.count)
                    yield (self._slice_pad(b1t, lo, hi, bs),
                           self._slice_pad(b2t, lo, hi, bs)
                           if b2t is not None else None,
                           bars[lo:hi] if o.sample_sheet else None)
            return
        if o.fastq1 and not o.bam_input:
            from ..io.fastq import iter_fastq_batches
            for r1, r2 in self._fastq_lane_files():
                yield from iter_fastq_batches(
                    r1, r2, o.batch_size,
                    barcode_path=o.barcode_fastq if o.sample_sheet else None)
            return
        if o.bam_input:
            # streaming BAM source: BGZF chunks + cross-chunk pair cache
            # (BamDataSource.hh:41-155) — bounded RAM, like FASTQ/BCL
            from ..io.bam_input import iter_bam_batches
            yield from iter_bam_batches(o.bam_input, o.batch_size)
            return
        for b1, b2 in self._read_batches():
            yield b1, b2, None

    @staticmethod
    def _slice_pad(b: ReadBatch, lo: int, hi: int, bs: int) -> ReadBatch:
        return pad_batch(ReadBatch(b.names[lo:hi], b.bases[lo:hi],
                                   b.quals[lo:hi], b.lengths[lo:hi]), bs)

    def _records_per_bin(self, read_len: int) -> int:
        """Bin size in records, capped by --memory-limit.  Per-record
        footprint through the Build phase: seq+qual bytes, name, packed
        cigars ×2 (own + mate), ~30 int columns, plus sort/dedup scratch
        of the same order -> budget a quarter of the limit for one
        resident bin."""
        o = self.opts
        records_per_bin = o.records_per_bin
        if o.memory_limit:
            rec_bytes = 2 * read_len + 64 + 8 * 16 * 2 + 128
            # --expected-bgzf-ratio (manual.md:373): the serialized-BAM
            # output buffer scales with the assumed compression ratio;
            # only the delta vs the default 1.0 adjusts the estimate
            rec_bytes += int((o.expected_bgzf_ratio - 1.0)
                             * (2 * read_len + 128))
            rec_bytes = max(rec_bytes, 64)
            fit = int(o.memory_limit * 1e9 * 0.25 / rec_bytes)
            if fit < records_per_bin:
                records_per_bin = max(fit, 10_000)
                from ..utils import tracing
                tracing.log(f"--memory-limit {o.memory_limit}G: "
                            f"records_per_bin -> {records_per_bin}")
        return records_per_bin

    def _phase_reports(self) -> None:
        """MatchSelectorStats / AlignmentReportGenerator analog: JSON +
        reference-shaped XML + a self-contained HTML report with inline
        SVG plots (workflow/reports.py)."""
        from . import reports
        stats = self._stats.get("match_selector", {})
        (self.stats_dir / "MatchSelectorStats.json").write_text(
            json.dumps(stats, indent=2))
        reports.write_match_selector_stats_xml(
            stats, self.stats_dir / "MatchSelectorStats.xml",
            sample=self.opts.sample)
        if "demultiplexing" in self._stats:
            reports.write_demultiplexing_stats_xml(
                self._stats["demultiplexing"],
                self.stats_dir / "DemultiplexingStats.xml")
        if "match_finder" in self._stats:
            reports.write_match_finder_stats_xml(
                self._stats["match_finder"],
                self.stats_dir / "MatchFinderStats.xml")
        reports.write_html_report(self._stats,
                                  self.stats_dir / "AlignmentReport.html",
                                  image_format=self.opts.stats_image_format)

    def _bin_regex_filter(self, genome):
        """--bin-regex: None (all) or a predicate over aligned-bin dirs.

        Each aligned bin is described as "contig:first-last" (the contig
        holding the bin's start); "unaligned" excludes every aligned bin
        (manual.md:317-323)."""
        import re

        spec = self.opts.bin_regex
        if spec in ("all", "", None):
            return None
        if spec == "unaligned":
            return lambda d: False
        bdoc_path = self.temp / "bins" / "boundaries.json"
        bin_bp = None
        boundaries = None
        if bdoc_path.exists():
            doc = json.loads(bdoc_path.read_text())
            bin_bp = doc["bin_bp"]
            if "boundaries" in doc:
                boundaries = np.asarray(doc["boundaries"], np.int64)
        rx = re.compile(spec)
        offs = genome.contig_offsets
        names = [c.name for c in genome.contigs]

        def describe(d) -> str:
            i = int(d.name.split("_")[1])
            if boundaries is not None:
                lo = int(boundaries[i])
                hi = int(boundaries[i + 1]) if i + 1 < len(boundaries) \
                    else genome.total_length
            elif bin_bp:
                lo, hi = i * bin_bp, (i + 1) * bin_bp
            else:
                lo, hi = 0, genome.total_length
            ci = int(np.searchsorted(offs, lo, side="right") - 1)
            ci = min(max(ci, 0), len(names) - 1)
            return f"{names[ci]}:{lo - offs[ci]}-{hi - offs[ci]}"

        return lambda d: bool(rx.search(describe(d)))

    def _library_ids(self, fb):
        """--single-library-samples 0: per-(sample, lane) library ids for
        duplicate marking; lanes parse from Illumina read names (BCL
        runs).  Default (1): per-sample (fb.rg, the dedup default)."""
        import numpy as np

        if self.opts.single_library_samples or not self.opts.run_folder:
            return None
        names = np.asarray(fb.names(), dtype="U")
        parts = np.char.partition(
            np.char.partition(np.char.partition(names, ":")[:, 2],
                              ":")[:, 2], ":")[:, 2]
        lane_s = np.char.partition(parts, ":")[:, 0]
        lanes = np.zeros(len(fb), np.int64)
        ok = np.char.isdigit(lane_s)
        lanes[ok] = lane_s[ok].astype(np.int64)
        return fb.rg.astype(np.int64) * 64 + lanes

    def _process_bin_fb(self, fb, genome):
        """Sort + dedup + realign one bin, columnar (BinSorter::process)."""
        import numpy as np

        from ..build.dedup import coordinate_sort_order, mark_duplicates_batch
        fb = fb.take(coordinate_sort_order(fb))
        if self.opts.mark_duplicates:
            lib = self._library_ids(fb)
            mesh = self._mesh()
            if mesh is not None:
                from ..build.dedup import mark_duplicates_collective
                fb = mark_duplicates_collective(
                    fb, mesh, keep=self.opts.keep_duplicates, lib=lib)
            else:
                fb = mark_duplicates_batch(fb, genome.contig_offsets,
                                           keep=self.opts.keep_duplicates,
                                           lib=lib)
        realigned = 0
        if self.opts.realign_gaps != "no":
            from ..build.realign import realign_batch
            if self.opts.realign_gaps == "all" or not self.opts.sample_sheet:
                scopes = [None]
            else:
                # per-sample (or per-project) gap scope: group on RG
                scopes = [np.nonzero(fb.rg == v)[0]
                          for v in np.unique(fb.rg)]
            for rows in scopes:
                changed = realign_batch(
                    fb, genome, rows,
                    max_gaps=self.opts.realigned_gaps_per_fragment,
                    realign_dodgy=self.opts.realign_dodgy)
                realigned += changed
                # --realign-vigorously: newly created gaps feed another
                # harvest+realign round (strictly-better acceptance
                # converges; 3 extra passes bound pathological bins)
                extra = 0
                while self.opts.realign_vigorously and changed and extra < 3:
                    changed = realign_batch(
                        fb, genome, rows,
                        max_gaps=self.opts.realigned_gaps_per_fragment,
                        realign_dodgy=self.opts.realign_dodgy)
                    realigned += changed
                    extra += 1
        return fb, realigned

    def _emit_fb(self, fb, writers: dict, contigs) -> None:
        """Route a coordinate-ordered columnar batch into the output BAM
        writer(s) — one per sample when demultiplexing (BarcodeBamMapping),
        one flat file otherwise."""
        import numpy as np

        from ..io.bam import BamWriter

        def writer_for(key: str | None) -> "BamWriter":
            w = writers.get(key)
            if w is None:
                if key is None:
                    path = self.out / "sorted.bam"
                    sample_name = self.opts.sample
                else:
                    d = self.out / key
                    d.mkdir(parents=True, exist_ok=True)
                    path = d / "sorted.bam"
                    sample_name = key
                o = self.opts
                w = BamWriter(path, contigs,
                              compression_level=o.compression_level,
                              sample=sample_name,
                              pu=self._pu_field(sample_name),
                              description=o.description,
                              reference_name=o.reference_name,
                              extra_tags=tuple(o.bam_header_tags))
                writers[key] = w
            return w

        from ..build.records import apply_tag_exclusions
        excl = self.opts.excluded_tags()
        if not self.opts.sample_sheet:
            writer_for(None).write_fragment_batch(
                apply_tag_exclusions(fb, excl))
            return
        for v in np.unique(fb.rg):
            rows = np.nonzero(fb.rg == v)[0]
            key = fb.rg_names[v] if 0 <= v < len(fb.rg_names) else "unknown"
            writer_for(key).write_fragment_batch(
                apply_tag_exclusions(fb.take(rows), excl))

    def _phase_bam(self) -> None:
        """Per-bin sort/dedup/realign + streaming BAM serialization
        (reference Build::sortBinParallel, lib/build/Build.cpp:509-903).
        Bins are processed in genome order so the concatenated output is
        globally coordinate-sorted; every step is columnar numpy.

        Three stages overlap (the reference's bin slots,
        Build.cpp:793-903): a loader thread reads bin i+1's chunk files
        while the main thread sorts/dedups/realigns bin i and an ordered
        writer stage serializes bin i-1 to BAM/BGZF.  The trailing
        unaligned bin — which no record-count budget sized — streams in
        bounded chunk groups in arrival order (it needs no sort: its
        records carry no coordinates, and arrival order is deterministic
        for a given input)."""
        from ..build.storage import BinnedFragmentStore
        from ..utils.pipeline import OrderedStage, prefetch_iter

        t0 = time.time()
        genome = self._genome()
        bins_dir = self.temp / "bins"
        bin_dirs = sorted(
            d for d in bins_dir.iterdir()
            if d.is_dir() and d.name.startswith("bin_")
        ) if bins_dir.is_dir() else []
        unal = bins_dir / "unaligned"
        cap = self._stats.get("records_per_bin") or self.opts.records_per_bin

        writers: dict = {}
        realigned = dup = n_records = max_bin = 0

        o = self.opts
        keep_unal = o.keep_unaligned
        if keep_unal not in ("discard", "front", "back"):
            raise ValueError(
                f"--keep-unaligned {keep_unal!r}: want discard|front|back")
        bin_filter = self._bin_regex_filter(genome)

        # RAM chunk cache from an in-process align phase (disk fallback
        # covers resume; build/storage.py BinnedFragmentStore cache)
        cache = getattr(self, "_bin_cache", None)
        from ..build.records import concat as _rconcat

        def load_aligned(d):
            if cache is not None:
                fb = cache.cached_bin(d.name)
                if fb is not None:
                    return fb
            return BinnedFragmentStore.load_bin(d)

        def unal_jobs():
            if keep_unal == "discard" or not unal.is_dir():
                return
            chunks = cache.cached_chunks("unaligned") if cache else None
            if chunks is not None:
                group, rows = [], 0
                for fb in chunks:
                    if group and rows + len(fb) > cap:
                        yield False, _rconcat(group)
                        group, rows = [], 0
                    group.append(fb)
                    rows += len(fb)
                if group:
                    yield False, _rconcat(group)
                return
            for fb in BinnedFragmentStore.iter_chunk_groups(unal, cap):
                yield False, fb

        def jobs():
            # --keep-unaligned front: unaligned clusters lead the BAM
            # (the reference crafts its .bai to skip them, manual.md:204)
            if keep_unal == "front":
                yield from unal_jobs()
            for d in bin_dirs:
                if bin_filter is not None and not bin_filter(d):
                    continue
                yield True, load_aligned(d)
            if keep_unal == "back":
                yield from unal_jobs()

        emit = OrderedStage(
            lambda fb: self._emit_fb(fb, writers, genome.contigs),
            window=max(1, o.output_parallel_save), name="isaac-bam")
        try:
            for is_bin, fb in prefetch_iter(jobs(), depth=1):
                if is_bin:
                    max_bin = max(max_bin, len(fb))
                    fb, r_cnt = self._process_bin_fb(fb, genome)
                    realigned += r_cnt
                dup += int(((fb.flag & sam.FLAG_DUPLICATE) != 0).sum())
                n_records += len(fb)
                emit.submit(fb)
        finally:
            emit.close()
        # post-hoc --memory-limit audit: the distribution-driven bin cuts
        # should have held every bin near its record budget
        if max_bin > 2 * cap:
            from ..utils import tracing
            tracing.log(f"bin budget exceeded: largest bin {max_bin} "
                        f"records vs {cap} budgeted (coverage hotspot "
                        f"narrower than one histogram span)", force=True)
            if self.opts.memory_control == "strict":
                # reference --memory-control strict (manual.md:429)
                from ..utils.errors import MemoryError_
                raise MemoryError_(
                    f"--memory-control strict: bin of {max_bin} records "
                    f"exceeds twice the {cap}-record budget")
        if not writers and not self.opts.sample_sheet:
            # no records at all: still emit a valid empty BAM
            from ..build.records import FragmentBatch
            self._emit_fb(FragmentBatch.empty(0, 1), writers, genome.contigs)
        for w in writers.values():
            w.close()

        # the RAM chunk cache is single-use (batches may be mutated
        # downstream; a rewound align phase rebuilds it)
        self._bin_cache = None
        if self.opts.cleanup_intermediary:
            # reference --cleanup-intermediary (manual.md:329): erase the
            # consumed bin chunks; bin-level resume is gone (like the
            # reference, --start-from Align still works)
            import shutil
            shutil.rmtree(self.temp / "bins", ignore_errors=True)
        self._stats["build"] = {"records": n_records, "duplicates": dup,
                                "realigned": realigned,
                                "bins": max(1, len(bin_dirs)),
                                "max_bin_records": max_bin,
                                "build_seconds": round(time.time() - t0, 2)}
        (self.stats_dir / "BuildStats.json").write_text(
            json.dumps(self._stats["build"], indent=2))
        from . import reports
        reports.write_build_stats_xml(self._stats["build"],
                                      self.stats_dir / "BuildStats.xml")

    # -- driver -------------------------------------------------------------

    def step(self) -> None:
        from ..utils import tracing
        transitions = {"Start": (self._phase_tls, "TlsDone"),
                       "TlsDone": (self._phase_align, "AlignDone"),
                       "AlignDone": (self._phase_reports, "ReportsDone"),
                       "ReportsDone": (self._phase_bam, "BamDone")}
        if self.state not in transitions:
            raise RuntimeError(f"cannot step from {self.state}")
        fn, next_state = transitions[self.state]
        pid, nproc = self._dist
        if nproc > 1 and pid != 0 and self.state in ("AlignDone",
                                                     "ReportsDone"):
            # multi-host: process 0 owns reports + the Build phase (it
            # reads every host's bin chunks off the shared temp dir);
            # other processes wait at the end-of-run barrier
            fn = lambda: None
        with tracing.phase(f"workflow {self.state} -> {next_state}"):
            fn()
        self.state = next_state

    def _fit_batch_size(self) -> None:
        """RAM-fit batch selection (reference SeedMemoryManager
        selectTiles, include/alignment/SeedMemoryManager.hh:40-60): cap
        the batch so in-flight device inputs + host result buffers stay
        inside a slice of --memory-limit.  Per row (250bp worst case):
        ~2 ends x 250 B bases/quals x ~4 copies (original, masked,
        oriented, result) + ~600 B of result columns ~ 5 KB; 3 batches
        are in flight (dispatch window + polish + convert)."""
        o = self.opts
        if o.clusters_at_a_time:
            # reference --clusters-at-a-time (manual.md:339): explicit
            # batch size wins over any RAM-based auto selection
            self.opts = dataclasses.replace(
                o, batch_size=o.clusters_at_a_time)
            return
        if not o.memory_limit:
            return
        per_row = 5_000 * 3
        fit = max(256, int(o.memory_limit * 1e9 * 0.15 / per_row))
        if fit < o.batch_size:
            from ..utils import tracing
            tracing.log(f"--memory-limit {o.memory_limit}G: "
                        f"batch_size {o.batch_size} -> {fit}")
            self.opts = dataclasses.replace(o, batch_size=fit)

    def run(self, start_from: str | None = None, stop_at: str = "BamDone",
            resume: bool = False) -> None:
        # a sample sheet with per-barcode reference/adapter columns runs
        # one sub-workflow per sample (workflow/per_barcode.py)
        if (self.opts.sample_sheet
                and getattr(self, "_stream_factory", None) is None):
            from .per_barcode import (PerBarcodeDriver,
                                      sheet_has_per_barcode_columns)
            if sheet_has_per_barcode_columns(self.opts.sample_sheet):
                PerBarcodeDriver(self.opts).run()
                return
        self._check_base_calls_format()
        self._fit_batch_size()
        if resume:
            self.load_state()
        if start_from:
            self.rewind(start_from)
        while STATES.index(self.state) < STATES.index(stop_at):
            self.step()
            self.save_state()
        if self._dist[1] > 1:
            from ..parallel.multihost import barrier
            barrier("workflow_done")
