from repro_torch.kernels.local_reduce.ops import local_reduce
from repro_torch.kernels.local_reduce.ref import PAD_KEY, local_reduce_ref

__all__ = ["local_reduce", "local_reduce_ref", "PAD_KEY"]
