from guacamole.pileup.element import (
    Alignment,
    AlignmentKind,
    PileupElement,
)
from guacamole.pileup.pileup import Pileup
