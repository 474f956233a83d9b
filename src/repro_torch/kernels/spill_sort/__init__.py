from repro_torch.kernels.spill_sort.ops import spill_sort

__all__ = ["spill_sort"]
