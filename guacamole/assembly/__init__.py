from guacamole.assembly.debruijn import DeBruijnGraph
