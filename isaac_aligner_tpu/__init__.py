"""isaac_aligner_tpu — an accelerator-native whole-genome short-read
alignment framework in JAX.

A from-scratch re-design of the capabilities of the iSAAC aligner
(reference: sequencing/isaac_aligner) for a GPU:

- the reference genome is pre-processed into a *sorted k-mer seed index*
  that lives in device memory (sharded by k-mer high bits across a mesh for
  large genomes, replicated for small ones),
- read batches stream through vectorized 2-bit seed generation,
- seed lookup is a vectorized binary-search/gather into the sorted index,
- candidate alignments are scored with vectorized ungapped scoring and a
  batched banded Smith-Waterman DP,
- paired-end template-length statistics, shadow-mate rescue and MAPQ run
  on-chip,
- coordinate sort / duplicate marking run as device sorts + collectives,
- a host layer does FASTA/FASTQ/SAM/BAM I/O and the checkpointed
  4-phase workflow (reference: src/c++/include/workflow/AlignWorkflow.hh).

This is an idiomatic JAX/XLA design, not a port of the reference C++.
"""

__version__ = "0.1.0"
