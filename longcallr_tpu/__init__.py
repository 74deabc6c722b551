"""longcallR-TPU: accelerated long-read RNA-seq SNP calling and phasing.

A from-scratch JAX/XLA re-design of the capabilities of
huangnengCSU/longcallR (Rust, CPU). Host side handles BAM/FASTA I/O and
ragged-to-dense tiling; all per-site/per-read/per-iteration math runs as
batched JAX programs on the accelerator (an NVIDIA GPU); regions are the
unit of data parallelism across a device mesh.
"""

__version__ = "0.1.0"

# jax is imported (and x64 enabled) by _jaxcfg from every jax-using module,
# NOT here: the analysis tools (ASE/ASJ) and plain I/O users stay jax-free —
# faster imports, and their fork()-based process pools never inherit jax's
# thread pool (fork + threads is deadlock-prone).

from .config import CallerConfig, preset  # noqa: F401
