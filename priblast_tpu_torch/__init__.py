"""priblast_tpu_torch — the PyTorch/CUDA port of priblast_tpu, for
comprehensive lncRNA-RNA interaction prediction on an NVIDIA GPU.

Two pipelines, mirroring the reference CLI (reference: src/main.cpp:148-175):

- ``db``  — build a database from a FASTA transcriptome: per-sequence
  accessibility (McCaskill-style inside/outside DP restricted to span W,
  a batched PyTorch engine on the device), suffix-array index + k-mer
  hash, paginated into chunks.
- ``ris`` — search query lncRNAs against the database: host seed search
  and SA expansion, ungapped extension on the device, host dedup, gapped
  extension on the device (a hand-written CUDA sweep kernel, csrc/), host
  finish, CSV output.

The on-disk database format is byte-compatible with the reference's
``.bas/.seq/.ind/.acc/.nam`` files. The package imports ``torch`` and
never ``jax``; it shares no module with ``priblast_tpu``.
"""

__version__ = "0.1.0"
