from guacamole.pack.events import EventKind, read_pileup_events
from guacamole.pack.tiles import LocusTile, pack_tile, pack_tiles
