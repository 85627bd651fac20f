"""chr21-scale DEVICE neighbor annotation measurement.

Runs find_neighbors_device on the unique k-mers of a repeat-rich
46.7 Mbp index and reports wall time split into upload/compile/execute.
prefer_device raises on failure instead of silently burning an hour on
the host path.  Also cross-checks a 2 Mbp slice against the host oracle
bit-for-bit.
"""
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import jax  # noqa: E402

from isaac_aligner_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from scripts.neighbor_scale_proof import make_genome  # noqa: E402
from isaac_aligner_tpu.index.build import build_index, unbias_i32_to_u32  # noqa: E402
from isaac_aligner_tpu.index.neighbors import annotate_index  # noqa: E402
from isaac_aligner_tpu.index.neighbors_tpu import find_neighbors_device  # noqa: E402

SMALL = "--small" in sys.argv
CHR21 = 5_000_000 if SMALL else 46_700_000
T0 = time.time()
log = lambda m: print(f"[+{time.time()-T0:7.1f}s] {m}", flush=True)

rng = np.random.default_rng(0)
log("first device sync")
jax.device_get(jax.numpy.zeros(8) + 1)
log("sync done")

# ---- oracle cross-check on a 2 Mbp slice -------------------------------
gs = make_genome(2_000_000, rng)
idx_s = build_index(gs, seed_len=32)
host_bits = annotate_index(idx_s.key_hi, idx_s.key_lo, k=32,
                           prefer_device=False)
dev_bits = annotate_index(idx_s.key_hi, idx_s.key_lo, k=32,
                          prefer_device=True)
assert np.array_equal(host_bits, dev_bits), (
    int((host_bits != dev_bits).sum()), "bits differ")
log(f"2 Mbp oracle check OK ({int(dev_bits.sum())} bits, device==host)")

# ---- chr21-scale device timing ----------------------------------------
log(f"building {CHR21/1e6:.0f} Mbp genome + index")
g = make_genome(CHR21, rng)
index = build_index(g, seed_len=32)
log(f"index: {index.num_records} records")

hi = unbias_i32_to_u32(np.asarray(index.key_hi)).astype(np.uint64)
lo = unbias_i32_to_u32(np.asarray(index.key_lo)).astype(np.uint64)
km = (hi << np.uint64(32)) | lo
uniq = np.unique(km)
log(f"{uniq.size} unique k-mers")
planes = ((uniq >> np.uint64(32)).astype(np.uint32),
          (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32))

t0 = time.time()
bits = find_neighbors_device(planes, 32)
t_dev = time.time() - t0
rssg = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
log(f"DEVICE annotation: {t_dev:.1f}s wall for {uniq.size} unique "
    f"k-mers ({int(bits.sum())} marked, "
    f"{100*bits.sum()/uniq.size:.2f}%), peak rss {rssg:.2f} GB "
    f"(host path measured 1163 s at this scale in round 4)")
# second run: executable cached, measures steady-state execute+transfer
t0 = time.time()
bits2 = find_neighbors_device(planes, 32)
log(f"DEVICE annotation (warm): {time.time()-t0:.1f}s")
assert np.array_equal(bits, bits2)
