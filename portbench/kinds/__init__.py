"""Traffic kinds: one generator a kind, ``kinds/<kind>.py``, named by a
traffic file's ``kind``; each module holds a ``Cell`` class."""

import numpy as np


def tile_mismatch(program, reference) -> int:
    """Tiles of the program's tiling (``Tile`` objects) that differ from
    the reference's (dicts), in order, plus the difference in count."""
    bad = abs(len(program) - len(reference))
    for p, r in zip(program, reference):
        if (p.grid_size != r["grid_size"] or p.cell_id != r["cell_id"]
                or not np.array_equal(p.points, r["points"])
                or not np.array_equal(p.indices, r["indices"])):
            bad += 1
    return bad
