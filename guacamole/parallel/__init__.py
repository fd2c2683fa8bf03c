from guacamole.parallel.mesh import (
    loci_mesh,
    sharded_call_step,
    stack_tiles,
)
