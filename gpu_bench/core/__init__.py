from gpu_bench.core.config import Config
from gpu_bench.core.timing import Timer, time_variant
from gpu_bench.core.reporting import Reporter
from gpu_bench.core.variants import Layouts, materialize

__all__ = ["Config", "Timer", "time_variant", "Reporter", "Layouts",
           "materialize"]
