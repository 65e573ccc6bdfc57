"""The record types the benchmark's maker writes a BAM with: BAM records,
their encoding and BAI index, and BGZF blocks. Copied from
pomfret_tpu_torch/io (bam.py to the record and its bin, bam_writer.py to
the record's encoding and the index, records.py, bgzf.py to the block),
so that later changes to the port do not move the benchmark's sets.
Nothing here decides anything: the reference is pbench/oracle.py.
"""
