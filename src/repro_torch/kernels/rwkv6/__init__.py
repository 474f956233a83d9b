from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import (
    DEFAULT_CHUNK,
    wkv6_chunk,
    wkv6_chunked_ref,
    wkv6_ref,
    wkv6_two_pass_ref,
)

__all__ = ["DEFAULT_CHUNK", "wkv6", "wkv6_chunk", "wkv6_chunked_ref", "wkv6_ref",
           "wkv6_two_pass_ref"]
