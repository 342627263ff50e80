from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                    MetricsRegistry, RunObs)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "RunObs"]
