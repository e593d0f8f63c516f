from repro_torch.kernels.bloom_query.ops import bloom_query
from repro_torch.kernels.bloom_query.ref import bloom_query_ref
