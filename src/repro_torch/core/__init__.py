# The paper's primary contribution: lossless input compression for learned
# (multidimensional) Bloom filters, plus the existence index around it
# (classic BF, LMBF/C-LMBF models, fixup filter, memory accounting).
from repro_torch.core import (bloom, compression, existence, fixup, lmbf,
                              memory)
