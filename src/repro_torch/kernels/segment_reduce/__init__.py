from repro_torch.kernels.segment_reduce.ops import row_key_sums, segment_reduce
from repro_torch.kernels.segment_reduce.ref import PAD_KEY, segment_reduce_ref

__all__ = ["segment_reduce", "segment_reduce_ref", "row_key_sums", "PAD_KEY"]
