from guacamole.ops.kernels import (
    allele_counts,
    genotype_log_likelihoods,
    genotype_pairs,
    probability_correct,
    tile_stats,
)
