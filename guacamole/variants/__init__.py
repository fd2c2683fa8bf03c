from guacamole.variants.allele import Allele, Genotype
from guacamole.variants.called import CalledAllele, CalledSomaticAllele
from guacamole.variants.evidence import AlleleEvidence
