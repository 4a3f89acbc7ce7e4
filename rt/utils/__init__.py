from rt.utils.compile_cache import enable_compile_cache
from rt.utils.profiling import (RenderStats, Timer, device_sync,
                                profile_trace, setup_logging)

__all__ = ["RenderStats", "Timer", "device_sync", "enable_compile_cache",
           "profile_trace", "setup_logging"]
