"""``encode_frames`` vs the oracle at levels 3 and 4 (see
test_encode_matrix.py for the geometries and bit depths)."""

import pytest

from test_encode_matrix import BIT_DEPTHS, GEOMETRIES, check_level


@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("level", [3, 4])
def test_encode_levels_3_4_match_oracle(level, geometry, bit_depth):
    check_level(level, geometry, bit_depth)
