from repro_torch.kernels.segment_reduce.ops import segment_reduce
from repro_torch.kernels.segment_reduce.ref import PAD_KEY, segment_reduce_ref

__all__ = ["segment_reduce", "segment_reduce_ref", "PAD_KEY"]
