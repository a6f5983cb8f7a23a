"""Per-frame metadata schema tests, incl. parity with the reference module."""

import numpy as np

from pyrecode_tpu import ReCoDeStructures


_HEADER = {"nx": 512, "ny": 512}


def test_binary_image_size():
    s = ReCoDeStructures(_HEADER)
    assert s.binary_image_sz_bytes == 512 * 512 // 8
    s2 = ReCoDeStructures({"nx": 9, "ny": 9})
    assert s2.binary_image_sz_bytes == (81 + 7) // 8


def test_metadata_sizes_match_reference(reference_tree):
    from pyrecode.structures import ReCoDeStructures as RefStructures

    ours = ReCoDeStructures(_HEADER)
    ref = RefStructures(_HEADER)
    for level in (1, 2, 3, 4):
        for mode in (0, 1):
            assert ours.get_standard_frame_metadata_size(level, mode) == \
                ref.get_standard_frame_metadata_size(level, mode), (level, mode)
            ours_fields = [f["name"] for f in ours.standard_frame_metadata_structure_for(level, mode)]
            ref_fields = [f["name"] for f in ref.standard_frame_metadata_structure_for(level, mode)]
            assert ours_fields == ref_fields, (level, mode)


def test_frame_data_sizes_match_reference(reference_tree):
    from pyrecode.structures import ReCoDeStructures as RefStructures

    ours = ReCoDeStructures(_HEADER)
    ref = RefStructures(_HEADER)
    md = {
        "bytes_in_packed_pixvals": 100,
        "bytes_in_compressed_binary_map": 55,
        "bytes_in_compressed_pixvals": 77,
        "bytes_in_packed_summary_stats": 33,
        "bytes_in_compressed_summary_stats": 44,
    }
    for level in (1, 2, 3, 4):
        for mode in (0, 1):
            assert ours.get_frame_data_size(level, mode, md) == \
                ref.get_frame_data_size(level, mode, md), (level, mode)
