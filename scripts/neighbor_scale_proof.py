"""Neighbor-annotation scale + truncation proof (VERDICT r4 item 6).

1. chr21-scale: build a repeat-rich ~47 Mbp genome, 32-mer index, run
   annotate_index_chunked, report wall time + peak RSS (the reference's
   findNeighbors step is a make-level out-of-core pass,
   lib/reference/NeighborsFinder.cpp:193-384; this is our bounded-RAM
   equivalent).
2. run_cap truncation: on a 5 Mbp slice, annotate with the production
   run_cap=256 vs uncapped, and report the fraction of neighbor bits the
   cap misses (must be <1%, else the cap must be raised).

Run: python scripts/neighbor_scale_proof.py [--small]
"""

import resource
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from isaac_aligner_tpu.index.build import build_index  # noqa: E402
from isaac_aligner_tpu.index.neighbors import annotate_index_chunked  # noqa: E402
from isaac_aligner_tpu.io.fasta import ContigMeta, Genome  # noqa: E402

SMALL = "--small" in sys.argv
CHR21 = 5_000_000 if SMALL else 46_700_000
SLICE = 1_000_000 if SMALL else 5_000_000


def make_genome(n, rng):
    """Repeat-rich: diverged element families force real neighbor mass."""
    codes = rng.integers(0, 4, n).astype(np.uint8)

    def paste(elem, copies, divergence):
        for _ in range(copies):
            p = int(rng.integers(0, n - len(elem)))
            mut = rng.random(len(elem)) < divergence
            codes[p : p + len(elem)] = np.where(
                mut, rng.integers(0, 4, len(elem)), elem)

    paste(rng.integers(0, 4, 300).astype(np.uint8), n // 150_000, 0.02)
    paste(rng.integers(0, 4, 6_000).astype(np.uint8), n // 1_500_000, 0.01)
    return Genome(codes=codes, contigs=[ContigMeta(
        index=0, name="chr21_sim", offset=0, length=n, md5="0" * 32)])


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    enable_compile_cache()
    rng = np.random.default_rng(0)

    # ---- 2. truncation measurement on the slice -------------------------
    print(f"[slice] building {SLICE/1e6:.0f} Mbp index", file=sys.stderr)
    gs = make_genome(SLICE, rng)
    idx_s = build_index(gs, seed_len=32)
    t0 = time.time()
    capped = annotate_index_chunked(idx_s.key_hi, idx_s.key_lo, k=32,
                                    run_cap=256)
    t_cap = time.time() - t0
    t0 = time.time()
    full = annotate_index_chunked(idx_s.key_hi, idx_s.key_lo, k=32,
                                  run_cap=1 << 30)
    t_full = time.time() - t0
    set_full = int(np.count_nonzero(full))
    missed = int(np.count_nonzero(full.astype(bool) & ~capped.astype(bool)))
    extra = int(np.count_nonzero(capped.astype(bool) & ~full.astype(bool)))
    frac = missed / max(set_full, 1)
    print(f"[slice] {SLICE/1e6:.0f} Mbp: {set_full} neighbor bits uncapped; "
          f"run_cap=256 misses {missed} ({frac*100:.4f}%), spurious {extra}; "
          f"capped {t_cap:.1f}s vs uncapped {t_full:.1f}s")
    assert extra == 0

    # ---- 1. chr21-scale wall/RSS ---------------------------------------
    print(f"[chr21] building {CHR21/1e6:.0f} Mbp genome + index",
          file=sys.stderr)
    g = make_genome(CHR21, rng)
    t0 = time.time()
    index = build_index(g, seed_len=32)
    t_build = time.time() - t0
    print(f"[chr21] index: {index.num_records} records in {t_build:.1f}s, "
          f"rss {rss_gb():.2f} GB")
    t0 = time.time()
    bits = annotate_index_chunked(index.key_hi, index.key_lo, k=32,
                                  run_cap=256)
    t_ann = time.time() - t0
    print(f"[chr21] annotate_index_chunked({CHR21/1e6:.0f} Mbp, "
          f"{index.num_records} records): {t_ann:.1f}s wall, "
          f"peak rss {rss_gb():.2f} GB, "
          f"{int(np.count_nonzero(bits))} neighbor bits "
          f"({np.count_nonzero(bits)/len(bits)*100:.2f}%)")


if __name__ == "__main__":
    main()
