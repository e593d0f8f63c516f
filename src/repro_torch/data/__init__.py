from repro_torch.data import tuples
