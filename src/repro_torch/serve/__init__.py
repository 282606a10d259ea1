from repro_torch.serve.decode import greedy_decode, greedy_generate
from repro_torch.serve.kvcache import cache_bytes

__all__ = ["cache_bytes", "greedy_decode", "greedy_generate"]
