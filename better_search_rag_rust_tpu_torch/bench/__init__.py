from .harness import (  # noqa: F401
    BenchmarkManager,
    BenchmarkTimer,
    BenchmarkTiming,
    format_time,
)
