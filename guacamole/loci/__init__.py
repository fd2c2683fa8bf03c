from guacamole.loci.locimap import LociMap, LociMapBuilder
from guacamole.loci.lociset import LociSet, LociSetBuilder, parse_loci
from guacamole.loci.partition import (
    partition_loci_by_approximate_depth,
    partition_loci_uniformly,
)
