from guacamole.filters.fishers import fishers_exact_test
from guacamole.filters.genotype_filters import apply_genotype_filters
from guacamole.filters.pileup_filters import (
    edge_base_filter,
    filter_pileup,
    multi_allelic_filter,
    quality_aligned_reads_filter,
)
from guacamole.filters.somatic_filters import apply_somatic_filters
