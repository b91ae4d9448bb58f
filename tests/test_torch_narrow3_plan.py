"""The split of #23's tiled kernel (csrc/transcode.cu narrow3), on the CPU.

``uniform3_utf16_to_utf8`` moves whole tiles of 4096 units with bulk
copies, which need the input (2 bytes a unit) and the output (3 bytes a
unit) on the 16-byte grid; the head before the first such unit, the tail
after the last whole tile, and every unit of a buffer with no such unit
take the element path. The host computes the split from the two addresses
(``narrow3_split``; ``kernels/transcode.narrow3_split`` is its twin, and
tests/test_torch_cuda.py holds the two together on the card). Here: every
unit falls in exactly one part, each tile is on the grid, and no step is
longer than 16 units, on aligned and unaligned views of several lengths.
"""

import numpy as np
import pytest

from simdutf_tpu_torch.kernels import transcode as ktr

T = ktr.N3_TILE
LENGTHS = [0, 1, 15, 16, 17, T - 1, T, T + 1, T + 15, T + 16, 2 * T + 7, 3 * T + 40]


def _cover(n: int, w_addr: int, out_addr: int):
    steps, tiles = ktr.narrow3_parts(w_addr, n, out_addr)
    hits = np.zeros(n, np.int64)
    for lo, hi in steps:
        assert 0 <= lo < hi <= n and hi - lo <= 16
        hits[lo:hi] += 1
    for lo, hi in tiles:
        assert hi - lo == T and hi <= n
        assert (w_addr + 2 * lo) % 16 == 0 and (out_addr + 3 * lo) % 16 == 0
        hits[lo:hi] += 1
    assert (hits == 1).all(), np.flatnonzero(hits != 1)[:8]
    return steps, tiles


@pytest.mark.parametrize("n", LENGTHS)
def test_every_unit_falls_in_one_part_on_unit_views(n):
    """Views of a uint16 buffer at every unit offset from the 16-byte
    grid, the output a fresh aligned buffer: only the view on the grid has
    tiles, with no head."""
    for in_off in range(0, 16, 2):
        steps, tiles = _cover(n, 4096 + in_off, 0)
        assert ktr.narrow3_split(4096 + in_off, n, 0) == (0, len(tiles))
        assert len(tiles) == (n // T if in_off == 0 else 0)


@pytest.mark.parametrize("n", LENGTHS)
def test_every_unit_falls_in_one_part_at_any_addresses(n):
    """Any byte offsets of input and output (the C entry point takes raw
    addresses): the head is the first unit that puts both on the grid, if
    a whole tile follows it."""
    for in_off in range(16):
        for out_off in range(16):
            steps, tiles = _cover(n, in_off, out_off)
            head, ntiles = ktr.narrow3_split(in_off, n, out_off)
            ok = [h for h in range(16)
                  if (in_off + 2 * h) % 16 == 0 and (out_off + 3 * h) % 16 == 0]
            if ok and n - ok[0] >= T:
                assert (head, ntiles) == (ok[0], (n - ok[0]) // T)
            else:
                assert (head, ntiles) == (0, 0) and not tiles
            assert len(steps) == (head > 0) + -(-(n - head - ntiles * T) // 16)
