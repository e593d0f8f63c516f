from repro_torch.nn.spec import ParamSpec, build_params, count_params
from repro_torch.nn import init, layers
