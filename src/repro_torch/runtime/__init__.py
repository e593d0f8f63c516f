from repro_torch.runtime.fault import StepTimer
from repro_torch.runtime.metrics import Histogram, LatencyWindow, MetricsLogger
from repro_torch.runtime.trace import NULL_TRACER, Span, Tracer
