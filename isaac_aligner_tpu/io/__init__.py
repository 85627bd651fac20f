"""Host-side I/O: FASTA/FASTQ readers, SAM/BAM writers.

These are the boundary between files and the fixed-shape device arrays the
device pipeline consumes (reference analog: src/c++/lib/io, lib/bam, lib/bgzf).
"""
