"""guacamole: a DNA variant-calling framework on JAX/XLA.

A from-scratch re-design of the capabilities of the Guacamole variant caller
(reference: Scala/Spark, surveyed in SURVEY.md) as a JAX/XLA pipeline:

 - Host side: BAM/SAM decoding, MD-tag reference reconstruction, loci
   partitioning, and packing of reads into fixed-shape per-locus-tile pileup
   tensors (replacing Spark RDDs + the loci shuffle,
   cf. the reference's DistributedUtil.scala:558-634).
 - Device side: per-locus allele counting, candidate screening, genotype
   log-likelihoods and somatic log-odds as XLA kernels, sharded
   over a loci-partitioned device mesh with psum/all_gather merging.
 - Callers: germline-threshold, germline-standard (Bayesian), somatic-standard
   (tumor/normal), variant-support, vaf-histogram, structural-variant.
"""

__version__ = "0.1.0"
