"""Device compute ops: bit packing, NPHD/Hamming scoring, fused top-k scans."""

from iscc_search_tpu.ops.packing import pack_codes, unpack_code
from iscc_search_tpu.ops.nphd import nphd_scores, hamming_scores
from iscc_search_tpu.ops.topk import topk_scan
from iscc_search_tpu.ops.pm1_scan import pm1_topk, prepare_queries, unpack_pm1

__all__ = [
    "pack_codes",
    "unpack_code",
    "nphd_scores",
    "hamming_scores",
    "topk_scan",
    "pm1_topk",
    "prepare_queries",
    "unpack_pm1",
]
