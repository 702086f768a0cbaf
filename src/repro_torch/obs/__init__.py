"""TraceKit copy: spans, metrics and exporters with the same schema and
trace lanes as ``repro.obs``, so ``tools/check_trace.py`` and
``tools/check_serving.py`` read the port's output unchanged."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.obs.export import (chrome_trace_dict, load_trace_file,
                                    merged_chrome_trace_dict,
                                    write_chrome_trace, write_jsonl,
                                    write_metrics_text, write_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "chrome_trace_dict", "load_trace_file", "merged_chrome_trace_dict",
    "write_chrome_trace", "write_jsonl", "write_metrics_text",
    "write_trace",
]
