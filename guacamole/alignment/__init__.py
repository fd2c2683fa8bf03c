from guacamole.alignment.affine_gap import (
    AlignmentState,
    ReadAlignment,
    align,
)
