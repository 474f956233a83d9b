from repro_torch.kernels.decode_attention.ops import decode_attention, split_plan, target_blocks, tile_keys
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "split_plan", "target_blocks",
           "tile_keys"]
