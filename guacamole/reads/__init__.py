from guacamole.reads.cigar import Cigar, CigarElement
from guacamole.reads.mdtag import MdTag
from guacamole.reads.read import (
    InputFilters,
    MappedRead,
    MateAlignmentProperties,
    PairedMappedRead,
    PairedRead,
    UnmappedRead,
    make_read,
)
